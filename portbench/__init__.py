"""The PyTorch and CUDA port's benchmark (``repro_torch`` on NVIDIA GPUs).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration in ``configs/<name>.json``, its
traffic mix in ``traffic/<name>.json`` (whose ``driver`` names
``drivers/<driver>.py``), its comparison limits in ``limits/<cell>.json``,
each per-layer metric's reader in ``metrics/<metric>.py`` and each
architecture's plain reference in ``reference/<arch>.py``. A new cell,
configuration, mix or metric is new files only.

The yardstick lives here, apart from the program: the token generator
(``tokens.py``), the data-sheet peaks (``peaks.py``), the model-FLOP and
kernel-bound counts from shapes (the references and the metric readers),
the trace reduction (``devtrace.py``) and the comparison that decides
``correct`` (``checks.py``). Nothing here imports JAX or the JAX package.
"""
