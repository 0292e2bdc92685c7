"""KV-block handoff between decoders — the disaggregated
prefill/decode substrate (a port of ``theanompi_tpu/serving/
kv_transfer.py``; numpy only).

Chunked prefill already isolates the phase boundary: after the last
chunk a request's state is exactly (its prompt's KV blocks, the first
sampled token).  This module turns that state into a portable HANDOFF
RECORD so one decoder can run the prefill and another the decode.

The record is host-side data — plain ints and strings plus per-layer
K/V numpy arrays ``[n_blocks, n_kv_heads, block_size, head_dim]`` — with
the JAX package's field names and values, so a record crosses between
the packages unchanged:

- ``dtype`` is the JAX name of the pools' dtype, ``"float32"`` or
  ``"bfloat16"``;
- fp32 K/V travel as numpy ``float32`` arrays;
- bf16 K/V travel as numpy ``uint16`` arrays holding the bfloat16 bits
  (numpy has no bfloat16, and the port does not need ``ml_dtypes``),
  as the port's TCP frames carry bf16; ``import_blocks`` reinterprets
  any 2-byte elements as bfloat16, so a JAX record whose arrays are
  ``ml_dtypes.bfloat16`` imports too.  The field set is the JAX one.

Receive: the decode engine allocates fresh blocks through its own
``BlockManager``, scatters the payload in, and seeds the slot directly
in the ``decode`` state with the prefiller's first token.  Only the
prompt's ``blocks_for(n_prompt)`` blocks ship; decode-side growth
allocates the rest.

``compatible`` is the refusal gate: geometry (layers, kv heads,
head_dim, block size, dtype) must match and the receiver's table must
hold the prompt.  An incompatible handoff sheds ``"handoff_failed"``
so whoever dispatched it can requeue the full prompt.
"""

from __future__ import annotations

import numpy as np

HANDOFF_VERSION = 1

#: fields every handoff record carries (the wire contract asserted by
#: ``compatible`` — bump HANDOFF_VERSION when this changes)
HANDOFF_FIELDS = (
    "version", "n_prompt", "first_token", "block_size", "n_blocks",
    "n_layers", "n_kv_heads", "head_dim", "dtype", "layers",
)


def dtype_name(decoder) -> str:
    """The JAX name of the decoder's pool dtype (``"float32"``,
    ``"bfloat16"``)."""
    return str(decoder.pools[0]["k"].dtype).removeprefix("torch.")


def build_handoff(decoder, manager, slot: int, n_prompt: int,
                  first_token: int, trace: dict | None = None) -> dict:
    """Export ``slot``'s prompt KV (the first ``blocks_for(n_prompt)``
    table entries) plus the sampled first token as a portable record.
    Call BEFORE the slot's blocks are freed.  ``trace`` (optional,
    NOT part of the ``compatible`` contract) carries the prefill
    side's span context so a router-less receiver still joins the
    decode leg's spans to the same trace; routed dispatches re-stamp
    ``Request.trace`` anyway."""
    n_blocks = manager.blocks_for(n_prompt)
    bids = manager.slot_blocks(slot, n_blocks)
    return {
        "version": HANDOFF_VERSION,
        "n_prompt": int(n_prompt),
        "first_token": int(first_token),
        "block_size": int(decoder.block_size),
        "n_blocks": int(n_blocks),
        "n_layers": int(decoder.model.n_layers),
        "n_kv_heads": int(decoder.model.n_kv_heads),
        "head_dim": int(decoder.model.head_dim),
        "dtype": dtype_name(decoder),
        "layers": decoder.export_blocks(bids),
        "trace": dict(trace) if trace is not None else None,
    }


def compatible(decoder, handoff: dict) -> tuple[bool, str]:
    """Can THIS decoder receive ``handoff``?  Returns ``(ok, why)``
    — the engine sheds ``"handoff_failed"`` with ``why`` in the log
    when not, and the router falls back to a full re-prefill.  The
    kv-head count compared is the model's GLOBAL one (a record carries
    every head whatever the sender's tp), so any tp receives it."""
    if not getattr(decoder, "paged", False):
        return False, "receiver is not a paged decoder"
    missing = [k for k in HANDOFF_FIELDS if k not in handoff]
    if missing:
        return False, f"handoff record missing {missing}"
    if handoff["version"] != HANDOFF_VERSION:
        return False, (
            f"handoff version {handoff['version']} != "
            f"{HANDOFF_VERSION}"
        )
    m = decoder.model
    geo = {
        "block_size": decoder.block_size,
        "n_layers": m.n_layers,
        "n_kv_heads": m.n_kv_heads,
        "head_dim": m.head_dim,
        "dtype": dtype_name(decoder),
    }
    for key, want in geo.items():
        if handoff[key] != want:
            return False, (
                f"handoff {key}={handoff[key]!r} != receiver "
                f"{want!r}"
            )
    if handoff["n_blocks"] > decoder.max_blocks:
        return False, (
            f"handoff needs {handoff['n_blocks']} blocks, receiver "
            f"tables hold {decoder.max_blocks}"
        )
    return True, ""


def inject_handoff(decoder, manager, slot: int, handoff: dict) -> None:
    """Receive a handoff into ``slot``: the caller has already
    reserved the table (``manager.assign(slot, [], n_blocks)``); this
    scatters the payload into the receiver's pools at the slot's
    fresh block ids (each rank of a tp > 1 receiver keeps its heads of
    the record's global ones).  After this the slot is exactly what a
    local prefill of the same prompt would have produced."""
    n = handoff["n_blocks"]
    if handoff["n_kv_heads"] != decoder.model.n_kv_heads:
        raise ValueError(f"handoff of {handoff['n_kv_heads']} kv heads "
                         f"for a model of {decoder.model.n_kv_heads}")
    if manager.n_owned[slot] < n:
        raise ValueError(f"slot {slot} owns {manager.n_owned[slot]} "
                         f"blocks, the handoff needs {n}")
    decoder.import_blocks(
        handoff["layers"], manager.slot_blocks(slot, n)
    )


def handoff_bytes(handoff: dict) -> int:
    """Wire size of the record's KV payload: 4 bytes an element for
    fp32, 2 for bf16 (its ``uint16`` bits)."""
    return int(sum(
        np.asarray(lkv["k"]).nbytes + np.asarray(lkv["v"]).nbytes
        for lkv in handoff["layers"]
    ))
