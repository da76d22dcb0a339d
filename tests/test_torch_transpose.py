"""The transpose of the DT x pass (the T2 port, ops/transpose_cuda.py) on
the CPU: its plain version, single and pair, its autograd Function, and
the 2-D DT with differentiable=True through it against the JAX package.

The kernel itself runs only on the card (tests/test_torch_cuda.py);
here the wrapper takes the plain version because the tensors lie on the
CPU, and never counts a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.ops import distance_transform as jdt
from partsbaseddetector_tpu_torch.ops import distance_transform as tdt
from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc
from partsbaseddetector_tpu_torch.utils.profiling import launch_counts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 33, 31), (2, 4, 5, 7)])
def test_transpose_plain_on_cpu(shape, dtype):
    x = torch.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    before = launch_counts()
    got = tc.transpose_last2(x)
    assert launch_counts() == before
    assert got.is_contiguous()
    assert torch.equal(got, x.transpose(-1, -2))
    assert torch.equal(tc.transpose_last2(got), x)


def test_transpose_gradient_is_the_transpose():
    x = torch.randn((3, 6, 4), requires_grad=True)
    cot = torch.randn((3, 4, 6))
    out = tc.transpose_last2(x)
    assert type(out.grad_fn).__name__ == "Transpose2FunctionBackward"
    (out * cot).sum().backward()
    assert torch.equal(x.grad, cot.transpose(-1, -2))


def test_transpose_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        tc.transpose_last2(torch.empty((2, 3, 4), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        tc.transpose_last2_pair(torch.empty((2, 3, 4), device="meta"),
                                torch.empty((2, 3, 4), device="meta"))


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 33, 31), (2, 4, 5, 7)])
def test_transpose_pair_on_cpu_is_two_plain_transposes(shape):
    """A float32 + int32 pair (the DT's values and pointers) through the
    pair entry equals the two plain transposes, and counts no launch."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    x.view(-1)[::3] = -torch.inf
    y = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape).astype(np.int32))
    before = launch_counts()
    xt, yt = tc.transpose_last2_pair(x, y)
    assert launch_counts() == before
    assert xt.dtype == torch.float32 and yt.dtype == torch.int32
    assert xt.is_contiguous() and yt.is_contiguous()
    assert torch.equal(xt, tc.transpose_last2_plain(x))
    assert torch.equal(yt, tc.transpose_last2_plain(y))
    want = tc.transpose_last2_pair_plain(x, y)
    assert torch.equal(xt, want[0]) and torch.equal(yt, want[1])
    back = tc.transpose_last2_pair(xt, yt)
    assert torch.equal(back[0], x) and torch.equal(back[1], y)


def test_transpose_pair_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="shapes .* differ"):
        tc.transpose_last2_pair(torch.zeros((2, 3, 4)), torch.zeros((2, 4, 3)))
    with pytest.raises(ValueError, match="shapes .* differ"):
        tc.transpose_last2_pair(torch.zeros((2, 3, 4)),
                                torch.zeros((3, 4), dtype=torch.int32))


def test_transpose_pair_gradient_is_the_transpose_of_the_value_cotangent():
    """Values with a gradient, pointers without: the pair's backward is
    the transpose of the values' cotangent alone."""
    x = torch.randn((3, 6, 4), requires_grad=True)
    y = torch.arange(72, dtype=torch.int32).reshape(3, 6, 4)
    cot = torch.randn((3, 4, 6))
    xt, yt = tc.transpose_last2_pair(x, y)
    assert type(xt.grad_fn).__name__ == "Transpose2FunctionBackward"
    assert not yt.requires_grad
    assert torch.equal(yt, y.transpose(-1, -2))
    (xt * cot).sum().backward()
    assert torch.equal(x.grad, cot.transpose(-1, -2))


def test_transpose_pair_gradient_of_two_float_tensors():
    x = torch.randn((2, 5, 3), requires_grad=True)
    y = torch.randn((2, 5, 3), requires_grad=True)
    cx, cy = torch.randn((2, 3, 5)), torch.randn((2, 3, 5))
    xt, yt = tc.transpose_last2_pair(x, y)
    ((xt * cx).sum() + (yt * cy).sum()).backward()
    assert torch.equal(x.grad, cx.transpose(-1, -2))
    assert torch.equal(y.grad, cy.transpose(-1, -2))
    # only one of the two used downstream
    x.grad = y.grad = None
    xt, yt = tc.transpose_last2_pair(x, y)
    (yt * cy).sum().backward()
    assert torch.equal(y.grad, cy.transpose(-1, -2))
    assert x.grad is None or not bool(x.grad.any())


def test_dt2d_runs_two_pair_transposes(monkeypatch):
    """The 2-D DT transposes through the pair entry, twice: the y pass's
    (values, pointers) in, the x pass's out."""
    calls = []
    orig = tdt.transpose_last2_pair

    def record(x, y):
        calls.append((tuple(x.shape), x.dtype, y.dtype))
        return orig(x, y)

    monkeypatch.setattr(tdt, "transpose_last2_pair", record)
    score = torch.randn((3, 2, 12, 10))
    wdef = torch.full((3, 2, 4), 0.05)
    msg, ptr = tdt.shift_distance_transform_2d_packed(
        score, wdef, torch.zeros((3, 2)), torch.zeros((3, 2)), 9, 11)
    assert msg.shape == ptr.shape == (3, 2, 11, 9)
    assert calls == [((3, 2, 11, 10), torch.float32, torch.int32),
                     ((3, 2, 9, 11), torch.float32, torch.int32)]


def _grad_fns(t):
    """Names of every autograd node reachable from t."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


@pytest.mark.parametrize("step,dlen_y,dlen_x", [(1, 11, 9), (2, 6, 5)])
def test_dt2d_differentiable_through_transpose_matches_jax(step, dlen_y, dlen_x):
    """The trainable 2-D DT (K4's backward for both passes, the x pass's
    transposes in Transpose2Function) over maps with a leading image
    axis, (G, B, S, M, H, W): values and the gradients of score and wdef
    equal the JAX package's XLA path (op by op)."""
    rng = np.random.RandomState(30 + step)
    G, B, S, M, H, W = 2, 2, 2, 2, 12, 10
    score = (rng.randn(G, B, S, M, H, W) * 4).astype(np.float32)
    score[..., 8:, :] = -1e10
    wdef = (np.abs(rng.randn(G, 1, 1, M, 4)) * 0.05 + 0.01).astype(np.float32)
    sx = rng.randint(-2, 3, (G, 1, 1, M)).astype(np.float32)
    sy = rng.randint(-2, 3, (G, 1, 1, M)).astype(np.float32)
    cot = rng.randn(G, B, S, M, dlen_y, dlen_x).astype(np.float32)

    def jloss(sc, wd):
        msg, _ = jdt.shift_distance_transform_2d_packed(
            sc, wd, jnp.asarray(sx), jnp.asarray(sy), dlen_x=dlen_x,
            dlen_y=dlen_y, step=step, differentiable=True,
        )
        return jnp.sum(msg * cot), msg

    (_, jmsg), (jg_s, jg_w) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True
    )(jnp.asarray(score), jnp.asarray(wdef))

    ts = torch.tensor(score, requires_grad=True)
    tw = torch.tensor(wdef, requires_grad=True)
    msg, ptr = tdt.shift_distance_transform_2d_packed(
        ts, tw, torch.from_numpy(sx), torch.from_numpy(sy), dlen_x, dlen_y,
        step, differentiable=True,
    )
    assert {"Transpose2FunctionBackward", "DT1dFunctionBackward"} <= _grad_fns(msg)
    assert ptr.dtype == torch.int32 and not ptr.requires_grad
    (msg * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(msg.detach().numpy(), np.asarray(jmsg), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg_s), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg_w), **TOL)
