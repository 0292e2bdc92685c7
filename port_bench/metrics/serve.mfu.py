"""``serve.mfu``: the model FLOPs of the decode calls in the window (each
active slot's token at its context, ``flops.serve_token_flops``; the
decoder's padded product rows are not counted) over those calls' wall
time and the card's bf16 peak, in percent: the decode step's share of
the peak."""

from port_bench.flops import PEAK_BF16


def read(rec):
    if not rec.get("decode_wall_s"):
        return None
    return 100.0 * rec["decode_flops"] / rec["decode_wall_s"] / PEAK_BF16
