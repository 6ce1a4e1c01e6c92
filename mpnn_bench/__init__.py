"""The benchmark of ``ionic_mpnn_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the root of the checkout lists the cells (a model
configuration under a traffic mix), their end-to-end and per-layer
metrics and their bounds. ``python -m mpnn_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once and prints one
JSON result line (:mod:`.run`).

Layout, every piece found by name:

* ``configs/<config>.json``: a configuration as it is run, with its source;
* ``reference/<config>.py``: its plain float32 reference (with
  ``reference/trunk.py``, ``train.py``, ``screen.py``, ``precision.py``);
* ``traffic/<mix>.json``: a traffic mix's parameters, made by
  :mod:`.gen` from the seed and driven by the driver of its ``kind``
  (:mod:`.train`, :mod:`.screen`);
* ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct`` (:mod:`.check`), with the readings they were set from;
* ``metrics/<metric>.py``: each per-layer metric's reader.

:mod:`.count` (peaks, kernel bounds, FLOPs), :mod:`.trace` (the
profiler's records) and :mod:`.gen` hold frozen copies of the program's
arithmetic and generator; :mod:`.program` is the one module that imports
the program. ``python -m mpnn_bench.calibrate`` reads the numbers the
limits are set from; ``python -m pytest mpnn_bench/tests`` runs the
benchmark's own tests (those marked ``card`` skip without a card).
"""
