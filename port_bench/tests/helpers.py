"""Tiny cells of the same equations, for runs of the drivers on the
CPU."""

from port_bench import spec

DATA = spec.HERE / "tests" / "data"

#: the limits of the tiny float32 cells: the port and the reference
#: agree to rounding there
TINY_LIMITS = {"numbers": {"loss_gap": {"limit": 1e-5},
                           "grad_gap": {"limit": 1e-5},
                           "change_gap": {"limit": 1e-5},
                           "served_gap": {"limit": 1e-4}}}


def tiny_cell(config: str, mix: str, serve: bool | None = None):
    mixd = spec.load_json(DATA / mix)
    serving = mixd["driver"] == "serve"
    numbers = {k: v for k, v in TINY_LIMITS["numbers"].items()
               if (k == "served_gap") == serving}
    return spec.Cell(name="tiny", chips=1, config_name=config,
                     config=spec.load_json(DATA / config),
                     traffic_name=mix, traffic=mixd,
                     limits={"numbers": numbers})
