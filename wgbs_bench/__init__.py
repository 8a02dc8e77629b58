"""The benchmark of the PyTorch / CUDA port (`bitmapperbs_tpu_torch`):
end-to-end reads/s of WGBS deployments on one NVIDIA card, traced down to
the kernels.  `python3 -m wgbs_bench --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`; README.md says how cells, traffic and metrics are
added."""
