"""The benchmark of the PyTorch and CUDA port (montecarlolocalisation_tpu_torch):
`python3 -m mclbench.run --workload NAME --seed N --seconds S --trace 0|1`.
See README.md in this folder."""
