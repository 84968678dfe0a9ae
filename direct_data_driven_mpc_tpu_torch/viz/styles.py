"""Matplotlib style presets for input-output plots.

Capability parity with ``utilities/visualization/plot_styles.py``
(normal + thin-line "small" variants for long sequences, setpoint and
legend styling). A copy of ``direct_data_driven_mpc_tpu/viz/styles.py``.
"""

# Line/legend parameter bundles passed through to plot_input_output.
INPUT_OUTPUT_PLOT_PARAMS = {
    "inputs_line_params": {"color": "tab:blue", "linewidth": 1.5},
    "outputs_line_params": {"color": "tab:blue", "linewidth": 1.5},
    "setpoints_line_params": {
        "color": "tab:red",
        "linestyle": "--",
        "linewidth": 1.5,
    },
}

# Thin-line variant for long sequences (initial excitation + run).
INPUT_OUTPUT_PLOT_PARAMS_SMALL = {
    "inputs_line_params": {"color": "tab:blue", "linewidth": 0.7},
    "outputs_line_params": {"color": "tab:blue", "linewidth": 0.7},
    "setpoints_line_params": {
        "color": "tab:red",
        "linestyle": "--",
        "linewidth": 1.0,
    },
}

SETPOINT_LINE_PARAMS = {
    "color": "tab:red",
    "linestyle": "--",
    "linewidth": 1.5,
}

LEGEND_PARAMS = {
    "fontsize": 10,
    "loc": "upper right",
    "framealpha": 0.9,
}
