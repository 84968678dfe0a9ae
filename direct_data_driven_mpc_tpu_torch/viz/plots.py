"""Static and animated input-output visualization.

Capability parity with
``utilities/visualization/data_visualization.py`` (static plot :15-359,
animation :361-818, export :820-856, helpers :858-1014): two subplot
rows (inputs / outputs), one subplot per channel, setpoint lines,
optional shaded initial-measurement region with auto-hiding labels,
overlay plotting into external axes, incremental-reveal animation with
FFmpeg export and a progress callback.

Pure host-side matplotlib driven by the metric arrays the engines
return (numpy). A copy of ``direct_data_driven_mpc_tpu/viz/plots.py``,
with the same names and behaviour.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.animation import FFMpegWriter, FuncAnimation
from matplotlib.axes import Axes
from matplotlib.figure import Figure


def get_padded_limits(
    X: np.ndarray, X_s: np.ndarray = None, pad_percentage: float = 0.05
) -> Tuple[float, float]:
    """Axis limits covering ``X`` (and optionally ``X_s``) with
    proportional padding (reference helper :858-888)."""
    X = np.asarray(X)
    lo, hi = float(X.min()), float(X.max())
    if X_s is not None and np.asarray(X_s).size:
        lo = min(lo, float(np.asarray(X_s).min()))
        hi = max(hi, float(np.asarray(X_s).max()))
    span = hi - lo
    pad = span * pad_percentage if span > 0 else max(abs(hi), 1.0) * 0.05
    return lo - pad, hi + pad


def get_text_width_in_data(
    text_object, axis: Axes, fig: Figure = None
) -> float:
    """Width of a rendered text object in data coordinates (reference
    helper :890-915): measure the bbox in display space and transform
    through the inverse axes transform. Used to auto-hide labels that
    would overflow their shaded region."""
    fig = fig or axis.get_figure()
    renderer = fig.canvas.get_renderer()
    bbox = text_object.get_window_extent(renderer=renderer)
    bbox_data = bbox.transformed(axis.transData.inverted())
    return float(bbox_data.width)


def remove_legend_duplicates(ax: Axes, legend_params: Dict) -> None:
    """De-duplicate legend entries by label (reference helper
    :917-948)."""
    handles, labels = ax.get_legend_handles_labels()
    seen: Dict[str, object] = {}
    for h, l in zip(handles, labels):
        if l not in seen:
            seen[l] = h
    if seen:
        ax.legend(seen.values(), seen.keys(), **legend_params)


def create_input_output_figure(
    m: int,
    p: int,
    figsize: Tuple[float, float] = (14.0, 8.0),
    dpi: int = 100,
    fontsize: int = 12,
    title: Optional[str] = None,
) -> Tuple[Figure, Sequence[Axes], Sequence[Axes]]:
    """Two subfigure rows: inputs on top, outputs below, one subplot
    per channel (reference factory :950-1014).

    Returns ``(fig, axs_u, axs_y)``.
    """
    fig = plt.figure(figsize=figsize, dpi=dpi)
    if title:
        fig.suptitle(title, fontsize=fontsize + 2)
    subfigs = fig.subfigures(2, 1)
    subfigs[0].suptitle("Control Inputs", fontsize=fontsize)
    subfigs[1].suptitle("System Outputs", fontsize=fontsize)
    axs_u = np.atleast_1d(subfigs[0].subplots(1, m))
    axs_y = np.atleast_1d(subfigs[1].subplots(1, p))
    for ax in list(axs_u) + list(axs_y):
        ax.tick_params(labelsize=fontsize - 2)
    return fig, axs_u, axs_y


def _plot_series(
    ax: Axes,
    data: np.ndarray,
    setpoint: Optional[float],
    var_symbol: str,
    index: int,
    T: int,
    line_params: Dict,
    setpoint_line_params: Dict,
    data_label: str,
    fontsize: int,
    initial_steps: Optional[int],
    initial_text: str,
    ylimit: Optional[Tuple[float, float]],
    display_initial_text: bool,
) -> None:
    """One channel's time series + optional setpoint + shaded initial
    region with auto-hidden label (reference plot_data :159-359)."""
    ax.plot(
        range(len(data)),
        data,
        **line_params,
        label=f"${var_symbol}_{index + 1}${data_label}",
    )
    if setpoint is not None:
        ax.plot(
            [0, T - 1],
            [setpoint, setpoint],
            **setpoint_line_params,
            label=f"${var_symbol}_{index + 1}^s$",
        )
    # Final limits BEFORE placing/measuring the region label so the
    # label lands and is measured against the rendered geometry.
    ax.set_xlim(0, T - 1)
    if ylimit is not None:
        ax.set_ylim(*ylimit)
    else:
        # Padded limits covering data + setpoint (the reference applies
        # get_padded_limits on the static path too, ref :292-322).
        ax.set_ylim(
            *get_padded_limits(
                data,
                None if setpoint is None else np.asarray([setpoint]),
            )
        )
    if initial_steps:
        ax.axvspan(0, initial_steps, color="gray", alpha=0.18)
        if display_initial_text:
            ylo, yhi = ax.get_ylim()
            text = ax.text(
                initial_steps / 2,
                ylo + 0.92 * (yhi - ylo),
                initial_text,
                ha="center",
                va="top",
                fontsize=fontsize - 2,
                color="dimgray",
            )
            # Auto-hide the label when its rendered width exceeds the
            # shaded region (reference hides overflowing text at
            # :324-345) -- measured in data coordinates.
            try:
                if get_text_width_in_data(text, ax) > initial_steps:
                    text.set_visible(False)
            except (AttributeError, RuntimeError):
                # Renderer not available (non-Agg backend pre-draw);
                # keep the label visible.
                pass
    ax.set_xlabel("Time step $k$", fontsize=fontsize)


def plot_input_output(
    u_k: np.ndarray,
    y_k: np.ndarray,
    u_s: np.ndarray,
    y_s: np.ndarray,
    inputs_line_params: Optional[Dict] = None,
    outputs_line_params: Optional[Dict] = None,
    setpoints_line_params: Optional[Dict] = None,
    initial_steps: Optional[int] = None,
    initial_excitation_text: str = "Init. Excitation",
    display_initial_text: bool = True,
    figsize: Tuple[float, float] = (14.0, 8.0),
    dpi: int = 100,
    fontsize: int = 12,
    title: Optional[str] = None,
    data_label: str = "",
    u_ylimits: Optional[List[Tuple[float, float]]] = None,
    y_ylimits: Optional[List[Tuple[float, float]]] = None,
    axs_u: Optional[Sequence[Axes]] = None,
    axs_y: Optional[Sequence[Axes]] = None,
    legend_params: Optional[Dict] = None,
    show: bool = True,
) -> Optional[Figure]:
    """Static input-output plot with setpoints.

    ``u_k``: ``(T, m)`` inputs, ``y_k``: ``(T, p)`` outputs, ``u_s`` /
    ``y_s``: setpoint column vectors (``(m, 1)`` / ``(p, 1)``) or flat
    arrays. Plots into freshly created subfigures, or overlays into
    external ``axs_u`` / ``axs_y`` (used by the multi-scheme
    reproduction figure; reference overlay path :146-157).

    Returns the created figure (None when plotting into external axes).
    """
    u_k = np.asarray(u_k)
    y_k = np.asarray(y_k)
    u_s_flat = np.asarray(u_s).reshape(-1) if u_s is not None else None
    y_s_flat = np.asarray(y_s).reshape(-1) if y_s is not None else None
    T, m = u_k.shape
    p = y_k.shape[1]

    inputs_line_params = inputs_line_params or {}
    outputs_line_params = outputs_line_params or {}
    setpoints_line_params = setpoints_line_params or {
        "color": "tab:red",
        "linestyle": "--",
    }
    legend_params = legend_params or {"fontsize": fontsize - 2}

    external_axes = axs_u is not None and axs_y is not None
    fig: Optional[Figure] = None
    if not external_axes:
        fig, axs_u, axs_y = create_input_output_figure(
            m=m, p=p, figsize=figsize, dpi=dpi, fontsize=fontsize,
            title=title,
        )

    for i in range(m):
        _plot_series(
            axs_u[i],
            u_k[:, i],
            None if u_s_flat is None else float(u_s_flat[i]),
            "u",
            i,
            T,
            inputs_line_params,
            setpoints_line_params,
            data_label,
            fontsize,
            initial_steps,
            initial_excitation_text,
            u_ylimits[i] if u_ylimits else None,
            display_initial_text,
        )
        axs_u[i].set_ylabel(f"$u_{i + 1}$", fontsize=fontsize)
        remove_legend_duplicates(axs_u[i], legend_params)
    for j in range(p):
        _plot_series(
            axs_y[j],
            y_k[:, j],
            None if y_s_flat is None else float(y_s_flat[j]),
            "y",
            j,
            T,
            outputs_line_params,
            setpoints_line_params,
            data_label,
            fontsize,
            initial_steps,
            "Init. Measurement",
            y_ylimits[j] if y_ylimits else None,
            display_initial_text,
        )
        axs_y[j].set_ylabel(f"$y_{j + 1}$", fontsize=fontsize)
        remove_legend_duplicates(axs_y[j], legend_params)

    if not external_axes and show:
        plt.show()
    return fig


def plot_input_output_animation(
    u_k: np.ndarray,
    y_k: np.ndarray,
    u_s: np.ndarray,
    y_s: np.ndarray,
    inputs_line_params: Optional[Dict] = None,
    outputs_line_params: Optional[Dict] = None,
    setpoints_line_params: Optional[Dict] = None,
    initial_steps: Optional[int] = None,
    figsize: Tuple[float, float] = (14.0, 8.0),
    dpi: int = 100,
    fontsize: int = 12,
    title: Optional[str] = None,
    interval: float = 20.0,
    points_per_frame: int = 5,
) -> FuncAnimation:
    """Incremental-reveal animation of the input-output trajectories.

    Reveals ``points_per_frame`` new samples per frame with blitting;
    the initial-measurement shading grows with the reveal (reference
    animation :361-818).
    """
    u_k = np.asarray(u_k)
    y_k = np.asarray(y_k)
    u_s_flat = np.asarray(u_s).reshape(-1)
    y_s_flat = np.asarray(y_s).reshape(-1)
    T, m = u_k.shape
    p = y_k.shape[1]

    inputs_line_params = inputs_line_params or {}
    outputs_line_params = outputs_line_params or {}
    setpoints_line_params = setpoints_line_params or {
        "color": "tab:red",
        "linestyle": "--",
    }

    fig, axs_u, axs_y = create_input_output_figure(
        m=m, p=p, figsize=figsize, dpi=dpi, fontsize=fontsize, title=title
    )

    lines = []
    spans = []
    texts = []  # (text, required_width) region labels, per axes
    all_axes = []

    def _setup_axis(ax, series, setpoint, sym, idx, line_params,
                    region_label):
        (ln,) = ax.plot([], [], **line_params, label=f"${sym}_{idx + 1}$")
        ax.plot(
            [0, T - 1],
            [setpoint] * 2,
            **setpoints_line_params,
            label=f"${sym}_{idx + 1}^s$",
        )
        ax.set_xlim(0, T - 1)
        ax.set_ylim(*get_padded_limits(series, setpoint))
        ax.set_ylabel(f"${sym}_{idx + 1}$", fontsize=fontsize)
        ax.set_xlabel("Time step $k$", fontsize=fontsize)
        ax.legend(fontsize=fontsize - 2, loc="upper right")
        lines.append(ln)
        all_axes.append(ax)
        if initial_steps:
            spans.append(ax.axvspan(0, 0, color="gray", alpha=0.18))
            # Region label, revealed once the grown rectangle is wide
            # enough to hold it (reference animates label visibility
            # per frame, data_visualization.py:561-604).
            ylo, yhi = ax.get_ylim()
            txt = ax.text(
                0,
                ylo + 0.92 * (yhi - ylo),
                region_label,
                ha="center",
                va="top",
                fontsize=fontsize - 2,
                color="dimgray",
                visible=False,
                animated=True,
            )
            try:
                fig.canvas.draw()  # renderer needed for measuring
                width = get_text_width_in_data(txt, ax)
            except (AttributeError, RuntimeError):
                width = 0.0  # no renderer: always show once grown
            texts.append((txt, width))

    for i in range(m):
        _setup_axis(
            axs_u[i], u_k[:, i], u_s_flat[i], "u", i,
            inputs_line_params, "Init. Excitation",
        )
    for j in range(p):
        _setup_axis(
            axs_y[j], y_k[:, j], y_s_flat[j], "y", j,
            outputs_line_params, "Init. Measurement",
        )

    n_frames = math.ceil((T - 1) / points_per_frame) + 1

    def update(frame):
        k = min(frame * points_per_frame, T - 1)
        xs = np.arange(k + 1)
        for i in range(m):
            lines[i].set_data(xs, u_k[: k + 1, i])
        for j in range(p):
            lines[m + j].set_data(xs, y_k[: k + 1, j])
        if initial_steps:
            grown = min(k, initial_steps)
            for span in spans:
                # Grow the shaded rectangle with the reveal (axvspan
                # returns a Rectangle in axes-fraction y, data x).
                span.set_width(grown)
            for txt, width in texts:
                # Show the label centered in the grown region once the
                # region can hold it; hide it again if a future variant
                # shrinks the region (per-frame visibility management).
                txt.set_x(grown / 2)
                txt.set_visible(grown > 0 and grown >= width)
        return lines + spans + [t for t, _ in texts]

    return FuncAnimation(
        fig,
        update,
        frames=n_frames,
        interval=interval,
        blit=True,
    )


def save_animation(
    animation: FuncAnimation,
    total_frames: int,
    fps: float,
    bitrate: int,
    file_path: str,
    progress_callback=None,
) -> None:
    """Export an animation (reference export :820-856).

    Uses FFmpeg when available; falls back to Pillow for ``.gif``
    output when ffmpeg is not installed (this keeps the reference's
    default ``.gif`` workflow working on ffmpeg-less hosts). Creates
    the output directory if needed; ``progress_callback`` gets
    ``(current_frame, total_frames)`` per frame (the reference wires a
    tqdm bar here).
    """
    out_dir = os.path.dirname(file_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if FFMpegWriter.isAvailable():
        writer = FFMpegWriter(fps=fps, bitrate=bitrate)
    elif file_path.lower().endswith(".gif"):
        from matplotlib.animation import PillowWriter

        writer = PillowWriter(fps=fps)
    else:
        raise RuntimeError(
            "ffmpeg is not available; install it or use a .gif output "
            "path (Pillow fallback)."
        )
    if progress_callback is None:
        try:
            from tqdm import tqdm

            bar = tqdm(total=total_frames, desc="Saving animation")

            def progress_callback(i, n):  # noqa: F811
                bar.update(1)

        except ImportError:
            progress_callback = None
    animation.save(
        file_path, writer=writer, progress_callback=progress_callback
    )
