"""The benchmark of the PyTorch and CUDA port (``cilqr_tpu_torch``) on
NVIDIA H100 cards: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of BENCHMARK.json once and
prints one JSON line of its metrics."""
