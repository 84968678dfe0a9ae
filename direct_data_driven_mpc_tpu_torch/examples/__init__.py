"""The example CLIs on the port, one module per JAX CLI of ``examples/``
under the same file name: ``direct_data_driven_mpc_example``,
``robust_data_driven_mpc_reproduction``, ``monte_carlo_example``,
``setpoint_tracking_example`` and ``regularization_tuning_example``.

Each has ``parse_args(argv=None)``, a pipeline function from the loaded
configs to numpy arrays, and ``main(argv=None)``; run one with ``python
-m direct_data_driven_mpc_tpu_torch.examples.<name>``. The device
engines run on the CUDA card unless given ``--device cpu``. The YAML
configs need PyYAML and the figures matplotlib, each imported by the
step that needs it.
"""
