"""portbench: the benchmark of the PyTorch/CUDA port (``dccrg_tpu_torch``).

One command runs one cell once::

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout lists the cells; each cell
names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), and each per-layer metric is read by
``metrics/<name>.py``.  The configuration's ``model`` picks the program-facing
driver (``systems/<model>.py``), the plain reference (``reference/<model>.py``)
and the frozen work counts (``work/<model>.py``).  See ``README.md``.

Importing this package imports nothing else.
"""
