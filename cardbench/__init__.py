"""cardbench: the benchmark of the PyTorch and CUDA port, ``mmlspark_tpu_torch``.

Run one cell from the root of a checkout::

    python3 cardbench/run.py --workload resnet50.featurize --seed 7 \
        --seconds 10 --trace 0

``BENCHMARK.json`` at the root names the cells; each cell's configuration
(``configs/``), traffic mix (``traffic/``), limits (``limits/``) and
per-layer readers (``metrics/``) are files of their own, found by name, and
so are each architecture family's reference (``reference/<family>.py``)
and FLOP count (``counts/<family>.py``). The yardstick lives here: the
traffic generators, the FLOP and byte counts (``counts/``), the trace
reduction and the plain reference (``reference/``) that decides
``correct``. Nothing here imports JAX or the JAX package.
"""
