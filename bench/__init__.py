"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card.  Everything a
cell needs is found by name: its configuration under ``configs/``, its
traffic mix under ``traffic/`` (a graph's generator under ``graphs/``),
its correctness limits under ``limits/``, each metric's reader under
``metrics/``, and the code of a model family under ``families/``.  The yardstick (traffic generation, work counts,
peaks, trace reduction and the plain references) lives here, apart from
the program.
"""
