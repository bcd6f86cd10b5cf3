"""The benchmark of the PyTorch and CUDA port (``torch_nerf_tpu_torch``) on
one H100: ``python3 -m nerfbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``. ``BENCHMARK.json`` at the repository's root lists the
cells and metrics; this package holds the harness, the plain reference
(``reference/``), the cells' data files and the metric readers."""
