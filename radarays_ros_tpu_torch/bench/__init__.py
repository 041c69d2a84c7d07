"""The port's measurement programs: twins of the JAX repo's bench.py and
benchmarks/ harnesses, each run as

    python -m radarays_ros_tpu_torch.bench.<name> [--device cpu] ...

headline (bench.py), engines, profile_frame, opti_scale, multichip
(bench_multichip.py), sweep_kernel_ab, order_ab, chunksize_ab and
make_demo; `common` holds what they share. argmin_ab.py has no twin: the
port's sweep has one argmin placement. Each twin runs on the card and
raises without one unless given --device cpu, prints JSON lines with the
card's name and power limit and the kernels' launches, and writes only
under build/ or to a path it is given.
"""
