"""The benchmark of the PyTorch and CUDA port
(``direct_data_driven_mpc_tpu_torch``); run it through ``run.py``."""
