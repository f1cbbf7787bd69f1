"""The benchmark of ``ray_tracer_fragment_shader_tpu_torch``, the PyTorch and
CUDA ray tracer.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by its name: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``.  The yardstick (the inputs
made from the seed, the plain reference that decides ``correct``, the
operation counts of the roofline and the statistics) lives here too, and
imports nothing of the program it measures.
"""
