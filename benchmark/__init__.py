"""The benchmark of the PyTorch + CUDA port (waifu2x_torch) on the H100.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell; README.md gives the layout."""
