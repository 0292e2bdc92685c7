"""The benchmark of ``theanompi_tpu_torch`` (the PyTorch and CUDA port).

Everything here is the yardstick: traffic generation from a seed, the
weights a run makes, the plain reference that decides ``correct``, the
arithmetic of model FLOPs, kernel bounds and device peaks, and the
reading of profiler traces.  From the port it takes only the system
under test (``models.llama.Llama``, the BSP step ``train_iter``, the
serving ``Engine`` over ``PagedLlamaDecoder``), its profiler ranges,
spans and kernel names.

One run of one cell::

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The harness is driven by data: a cell of ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``), a traffic mix
(``traffic/<mix>.json``, whose ``driver`` key names the general driver
in ``drivers/``) and has its limits in ``limits/<cell>.json``; each
per-layer metric is read by ``metrics/<metric>.py``.  A new cell, mix
or metric is a new file.
"""
