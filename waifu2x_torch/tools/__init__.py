"""Measurement entry points of the port, run as modules on a CUDA card:
python3 -m waifu2x_torch.tools.layer_time_probe,
python3 -m waifu2x_torch.tools.i8_fidelity_probe."""
