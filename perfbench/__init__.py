"""The benchmark of the PyTorch/CUDA port (``casmvsnet_pl_tpu_torch``).

``run.py`` runs one cell once: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``. Every piece is found by name:
``configs/<config>.json`` (a model configuration), ``workloads/<cell>.json``
(a cell: its configuration, traffic mix, chips, limits), ``traffic/<mix>.json``
(a mix's parameters) read by ``traffic/<kind>.py`` (one loop per kind),
``metrics/<metric>.py`` (one per-layer metric, read from the traced window).
``reference/`` is the plain PyTorch reference that decides ``correct``;
``counts/`` holds the frozen FLOP and byte counts.
"""
