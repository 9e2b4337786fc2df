"""The benchmark of ``porous_cfd_tpu_torch`` on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
limits (``limits/<cell>.json``) and per-layer metric readers
(``metrics/<name>.py``) are files found by name, and so is the code those
files name: a configuration's model family (``families/<family>.py``: its
work count and plain reference forward) and inputs
(``datasets/<dataset>.py``), a mix's kind of run (``kinds/<kind>.py``). A
cell, a mix, a configuration, a family or a metric is added with files and
entries alone. The plain float32 reference that decides ``correct`` is
``reference/`` with the families' forwards; it imports nothing of the
program. This package imports nothing heavy when it is imported.
"""
