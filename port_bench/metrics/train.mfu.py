"""``train.mfu``: the model FLOPs of the window's training steps (6 ×
the active matmul parameters a token plus causal attention, no remat
replay, no capacity padding; ``flops.train_step_flops``) over the
window's wall time and the card's bf16 peak, in percent."""

from port_bench.flops import PEAK_BF16


def read(rec):
    if "step_flops" not in rec or not rec.get("window_wall_s"):
        return None
    return (100.0 * rec["step_flops"] * rec["window_steps"]
            / rec["window_wall_s"] / PEAK_BF16)
