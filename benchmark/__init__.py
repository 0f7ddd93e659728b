"""The benchmark of the PyTorch and CUDA port (`umbrella_tpu_torch`) on one
NVIDIA H100. Entry point: `python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>` from the repository root; see README.md."""
