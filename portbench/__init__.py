"""The port's benchmark: one cell of BENCHMARK.json run once per process.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` measures a cell on the card; ``portbench/rehearse.py`` runs
the same drivers on the CPU at a tiny size. Everything that belongs to one
configuration, traffic mix, driver kind, cell or per-layer metric is a file
of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py``,
``limits/<cell>.json``, ``metrics/<metric>.py``. ``reference/`` is the plain
PyTorch reference that decides ``correct``.
"""
