"""The benchmark of the PyTorch and CUDA port (``pathtracing_tpu_torch``).

One run of one cell:

    python3 -m ptbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration in ``configs/<name>.json`` (the scene module it names lives
in ``scenes/``), its traffic mix in ``traffic/<name>.json`` (data: the
closed loop in ``loops/<loop>.py`` that it names, and that loop's
parameters; ``drive.py`` says what a loop gives) and each metric in
``metrics/<name>.py`` (a reader of the run's record). The plain reference
that decides ``correct`` is ``reference/``; it imports nothing of the port.
"""
