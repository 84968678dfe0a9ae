"""PyTorch port, the paper reproduction (``reproduction/``) and the
figures (``viz/``): the three Robust schemes' closed loops and the
equilibrium-state forcing against the JAX package on the same seed (both
on their host loops, float64), and every figure against the JAX
package's on the same arrays: axes, each line's data, limits, labels and
texts, for the four plot cases of tests/test_examples.py (static plot,
padded limits, animation region labels, the GIF fallback) and the
reproduction's overlaid figure."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from direct_data_driven_mpc_tpu.control import operation as jop  # noqa: E402
from direct_data_driven_mpc_tpu.reproduction import paper as jpaper  # noqa: E402
from direct_data_driven_mpc_tpu.viz import plots as jplots  # noqa: E402
from direct_data_driven_mpc_tpu_torch.examples import common  # noqa: E402
from direct_data_driven_mpc_tpu_torch.examples import (  # noqa: E402
    robust_data_driven_mpc_reproduction as repro,
)
from direct_data_driven_mpc_tpu_torch.reproduction import paper  # noqa: E402
from direct_data_driven_mpc_tpu_torch.viz import plots  # noqa: E402

from tests.test_torch_examples import _jax_configs  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

EXACT = 1e-10  # float64 host loops, the native solve on both sides
U_S, Y_S = np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]])


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _jax_reproduction(t_sim, seed):
    """examples/robust_data_driven_mpc_reproduction.py:96-190 on the JAX
    package: ``(u_data, y_data)``."""
    model, config = _jax_configs()
    rng = np.random.default_rng(seed)
    model.set_state(jop.randomize_initial_system_state(model, config, rng))
    u_d, y_d = jop.generate_initial_input_output_data(model, config, rng)
    schemes = [jpaper.DataDrivenMPCScheme[s.name] for s in repro.SCHEMES]
    controllers = jpaper.create_data_driven_mpc_controllers_reproduction(
        config, u_d, y_d, schemes)
    model.set_state(jpaper.get_equilibrium_state_from_output(
        model, np.array(repro.Y_0).reshape(-1, 1)))
    U_n, Y_n = jop.simulate_n_input_output_measurements(model, config, rng)
    for c in controllers:
        c.set_past_input_output_data(u_past=U_n.reshape(-1, 1),
                                     y_past=Y_n.reshape(-1, 1))
    u, y = jpaper.simulate_data_driven_mpc_control_loops_reproduction(
        model, controllers, t_sim + 1 - config["n"], rng, verbose=0)
    return ([np.vstack([U_n, a]) for a in u],
            [np.vstack([Y_n, a]) for a in y])


@pytest.fixture(scope="module")
def schemes():
    """The port's and JAX's three schemes at t_sim 60, seed 4."""
    args = repro.parse_args(["--t_sim", "60", "--verbose", "0"])
    got = repro.simulate(*common.load_configs(), args)
    return got, _jax_reproduction(60, 4)


def test_three_schemes_match_jax(schemes):
    (u, y), (ju, jy) = schemes
    assert [a.shape for a in u] == [(61, 2)] * 3
    for name, a, b in zip(("TEC", "TEC_N_STEP", "UCON"), u, ju):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT, err_msg=name)
    for name, a, b in zip(("TEC", "TEC_N_STEP", "UCON"), y, jy):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT, err_msg=name)
    np.testing.assert_allclose(y[0][0], 0.4, atol=0.005)  # forced y_0


@pytest.mark.parametrize("y_eq", [[0.4, 0.4], [0.65, 0.77], [-0.3, 1.2]])
def test_equilibrium_state_matches_jax(y_eq):
    model, _ = common.load_configs()
    jmodel, _ = _jax_configs()
    y_eq = np.array(y_eq).reshape(-1, 1)
    got = paper.get_equilibrium_state_from_output(model, y_eq)
    want = jpaper.get_equilibrium_state_from_output(jmodel, y_eq)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_scheme_configs_match_jax():
    for scheme in paper.DataDrivenMPCScheme:
        jscheme = jpaper.DataDrivenMPCScheme[scheme.name]
        assert scheme.value == jscheme.value
        assert paper.DD_MPC_SCHEME_CONFIG[scheme] == \
            jpaper.DD_MPC_SCHEME_CONFIG[jscheme]
        assert paper.DD_MPC_SCHEME_LINE_PARAMS[scheme] == \
            jpaper.DD_MPC_SCHEME_LINE_PARAMS[jscheme]
    with pytest.raises(ValueError, match="not found"):
        paper.create_data_driven_mpc_controllers_reproduction(
            common.load_configs()[1], np.zeros((10, 2)), np.zeros((10, 2)),
            ["TEC"])


def _summary(fig):
    """What a figure shows, in drawing order: per axes, each line's data
    and style, the limits, scales, labels, title, texts with their
    visibility and position, and the legend's entries; the figure's and
    subfigures' titles."""
    axes = []
    for ax in fig.get_axes():
        axes.append(dict(
            lines=[(ln.get_xydata().tolist(), ln.get_label(),
                    ln.get_color(), ln.get_linestyle(), ln.get_linewidth())
                   for ln in ax.get_lines()],
            xlim=ax.get_xlim(), ylim=ax.get_ylim(),
            scales=(ax.get_xscale(), ax.get_yscale()),
            labels=(ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
            texts=[(t.get_text(), t.get_visible(), t.get_position())
                   for t in ax.texts],
            legend=None if ax.get_legend() is None else [
                t.get_text() for t in ax.get_legend().get_texts()],
            patches=len(ax.patches),
        ))
    titles = [f._suptitle.get_text() for f in [fig, *fig.subfigs]
              if f._suptitle is not None]
    return axes, titles


def _same_figure(got, want):
    g_axes, g_titles = _summary(got)
    w_axes, w_titles = _summary(want)
    assert g_titles == w_titles
    assert len(g_axes) == len(w_axes)
    for i, (g, w) in enumerate(zip(g_axes, w_axes)):
        assert g == w, f"axes {i}"


def _data(seed=0, T=50, m=2, p=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(T, m)), rng.normal(size=(T, p))


def test_reproduction_figure_matches_jax(schemes):
    (u, y), _ = schemes
    kw = dict(u_s=U_S, y_s=Y_S, u_ylimits=repro.U_YLIMITS,
              y_ylimits=repro.Y_YLIMITS, title="Robust Data-Driven MPC "
              "Schemes", show=False, dpi=50)
    got = paper.plot_input_output_reproduction(repro.SCHEMES, u, y, **kw)
    want = jpaper.plot_input_output_reproduction(
        [jpaper.DataDrivenMPCScheme[s.name] for s in repro.SCHEMES], u, y,
        **kw)
    _same_figure(got, want)
    assert len(got.get_axes()) == 4
    assert len(got.get_axes()[0].get_lines()) == 3 * 2  # data, setpoint


def test_static_plot_matches_jax(tmp_path):
    u, y = _data()
    kw = dict(initial_steps=20, show=False, title="static")
    got = plots.plot_input_output(u, y, U_S, Y_S, **kw)
    want = jplots.plot_input_output(u, y, U_S, Y_S, **kw)
    got.canvas.draw()
    want.canvas.draw()
    _same_figure(got, want)
    path = tmp_path / "static.png"
    got.savefig(path)
    assert path.stat().st_size > 0
    fig, axs_u, axs_y = plots.create_input_output_figure(m=2, p=2)
    assert len(axs_u) == 2 and len(axs_y) == 2


def test_static_plot_applies_padded_limits():
    u, y = _data(T=30, m=1, p=1)
    y = 0.1 * y
    y_s = np.array([[5.0]])  # far outside the data's range
    expected = plots.get_padded_limits(y[:, 0], np.array([5.0]))
    assert expected == jplots.get_padded_limits(y[:, 0], np.array([5.0]))
    got = plots.plot_input_output(u, y, np.array([[1.0]]), y_s, show=False)
    np.testing.assert_allclose(got.get_axes()[-1].get_ylim(), expected,
                               rtol=1e-9)
    assert got.get_axes()[-1].get_ylim()[1] > 5.0
    _same_figure(got, jplots.plot_input_output(u, y, np.array([[1.0]]),
                                               y_s, show=False))
    for X in (np.zeros(4), np.array([2.0, 2.0])):  # a flat series
        assert plots.get_padded_limits(X) == jplots.get_padded_limits(X)


def test_animation_region_labels_match_jax():
    """Frame by frame, the region labels start hidden, appear once the
    grown region holds them, centred in it, as in the JAX package's
    animation; the lines and spans equal."""
    u, y = _data(T=200)
    kw = dict(initial_steps=150, points_per_frame=10)
    got = plots.plot_input_output_animation(u, y, U_S, Y_S, **kw)
    want = jplots.plot_input_output_animation(u, y, U_S, Y_S, **kw)
    for anim in (got, want):
        anim._fig.canvas.draw()
    texts = lambda a: [t for ax in a._fig.get_axes() for t in ax.texts
                       if "Init." in t.get_text()]
    assert len(texts(got)) == 4
    for frame in (0, 5, 15, 19):
        artists = got._func(frame)
        want._func(frame)
        _same_figure(got._fig, want._fig)
        assert len(artists) == 4 + 4 + 4  # lines, spans, labels
    assert all(t.get_visible() for t in texts(got))
    assert all(abs(t.get_position()[0] - 75) < 1e-9 for t in texts(got))
    got._func(0)
    assert not any(t.get_visible() for t in texts(got))


def test_save_animation_gif_fallback(tmp_path, monkeypatch):
    """Without ffmpeg a ``.gif`` goes through Pillow, any other
    extension raises; with the same frames as the JAX package's."""
    from matplotlib.animation import FFMpegWriter

    monkeypatch.setattr(FFMpegWriter, "isAvailable",
                        classmethod(lambda cls: False))
    u, y = _data(T=20)
    sizes = []
    for mod in (plots, jplots):
        anim = mod.plot_input_output_animation(u, y, U_S, Y_S,
                                               points_per_frame=10)
        path = tmp_path / mod.__name__.split(".")[0] / "anim.gif"
        seen = []
        mod.save_animation(anim, total_frames=3, fps=5, bitrate=100,
                           file_path=str(path),
                           progress_callback=lambda i, n: seen.append(i))
        assert path.stat().st_size > 0 and seen == [0, 1, 2]
        sizes.append(path.stat().st_size)
        with pytest.raises(RuntimeError, match="ffmpeg"):
            mod.save_animation(anim, 3, 5, 100, str(tmp_path / "a.mp4"))
    assert sizes[0] == sizes[1]


def test_reproduction_main_saves_the_figure(tmp_path, capsys):
    fig = tmp_path / "fig2.png"
    repro.main(["--t_sim", "30", "--verbose", "1", "--save_fig", str(fig)])
    assert fig.stat().st_size > 0
    out = capsys.readouterr().out
    assert "TEC" in out and "UCON" in out and "Figure saved" in out
