"""PyTorch port, the CUDA kernel on a card: ``fused_rollout`` against
its plain PyTorch version and against the framework-free goldens.

These tests need an NVIDIA card and skip without one. This file
imports no JAX, so on a machine without it run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    build_linear_engine,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_golden.npz"
)
PLANT = LTIParams(
    A=np.array([[0.921, 0, 0.041, 0], [0, 0.918, 0, 0.033],
                [0, 0, 0.924, 0], [0, 0, 0, 0.937]]),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _controller(golden, n_mpc_step=1):
    L = 30
    return DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=golden["u_d"], y_d=golden["y_d"], L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=n_mpc_step,
    )


def _packed(golden, bm, n_steps, batch, device, seed=0):
    p = 2
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(np.tile(golden["x0"], (batch, 1)),
                          dtype=torch.float32, device=device)
    ups = torch.as_tensor(
        np.tile(golden["TEC_u_past0"][None], (batch, 1, 1)),
        dtype=torch.float32, device=device,
    )
    yps = torch.as_tensor(
        np.tile(golden["TEC_y_past0"][None], (batch, 1, 1)),
        dtype=torch.float32, device=device,
    )
    Ws = torch.as_tensor(0.002 * rng.uniform(-1, 1, (batch, n_steps, p)),
                         dtype=torch.float32, device=device)
    K = bm.os_c.shape[0] // bm.M_T.shape[0]
    n_outer = math.ceil(n_steps / K)
    return fr._center_and_pack(bm, x0s, ups, yps, Ws, n_outer, K,
                               n_outer * K - n_steps)


@pytest.mark.parametrize(
    "n_steps,K,batch,w_off",
    [(40, 8, 16, 0), (37, 8, 40, 2), (400, 50, 4096, 3)],
)
def test_kernel_matches_plain_version(cuda, golden, n_steps, K, batch,
                                      w_off):
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=K, device=cuda)
    op = fr._build_fused_operator(bm)
    s0, W = _packed(golden, bm, n_steps, batch, cuda)
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == before + 1
    U, Y, C, s_fin = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    for a, b in zip((got[0], got[1], got[3]), (U, Y, s_fin)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(got[2], C, rtol=1e-3, atol=1e-5)


def test_kernel_matches_golden(cuda, golden):
    """The kernel through the batched entry point meets the float32
    north-star budget on the TEC golden run."""
    n_steps = 120
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=10, device=cuda)
    args = [
        torch.as_tensor(np.asarray(golden[k])[None], dtype=torch.float32,
                        device=cuda)
        for k in ("x0", "TEC_u_past0", "TEC_y_past0")
    ]
    Ws = torch.as_tensor(golden["w_sys"][:n_steps][None],
                         dtype=torch.float32, device=cuda)
    before = fr.fused_rollout.launches
    res = fr.pallas_batched_rollout(bm, *args, Ws, n_steps)
    assert fr.fused_rollout.launches == before + 1
    du = np.abs(res.u_sys[0].double().cpu().numpy()
                - golden["TEC_u"]).max()
    assert du < 1e-4, du


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, golden):
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=8, device=cuda)
    op = fr._build_fused_operator(bm)
    s0, W = _packed(golden, bm, 40, 16, cuda)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_rollout(op, s0.double(), W)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_rollout(op, s0, W.transpose(0, 1).contiguous()
                         .transpose(0, 1))
    with pytest.raises(ValueError, match="w_off"):
        fr.fused_rollout(op, s0, W, w_off=W.shape[1])
