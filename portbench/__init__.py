"""The benchmark of ``smart_nar_fast_tts_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations (``configs/``), traffic mixes (``traffic/``)
and per-layer metrics (``metrics/``) are files found by the names that
``BENCHMARK.json`` gives, and model families (``families/``) by the names
a configuration gives; ``reference/`` holds the plain PyTorch reference
that decides ``correct``; ``harness/`` the general code.
"""
