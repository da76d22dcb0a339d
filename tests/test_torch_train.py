"""The torch port's SGD training step against the JAX package.

Both packages start from the same weights (the JAX package's
`model_params`, carried over with `params_from_jax`) and the same seeded
images. The JAX side runs op by op, without jit: under jit XLA:CPU
contracts the distance transform's a*d + b into an FMA, which can move
an argmax at a near-tie, while op by op its XLA path rounds each
operation as the port does. Losses agree to 1e-5, gradients and updated
pools within rtol 1e-4, atol 1e-5 (the conv and the hinge's sums run in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu.pipeline import build_root_masks as jbuild_root_masks
from partsbaseddetector_tpu.pipeline import make_plan as jmake_plan
from partsbaseddetector_tpu.train import sgd as jsgd
from partsbaseddetector_tpu_torch import pipeline as tpipe
from partsbaseddetector_tpu_torch.models.convert import (
    model_from_jax,
    params_from_jax,
    params_to_numpy,
)
from partsbaseddetector_tpu_torch.models.model import pack_model as tpack
from partsbaseddetector_tpu_torch.models.model import to_device
from partsbaseddetector_tpu_torch.train import checkpoint as tckpt
from partsbaseddetector_tpu_torch.train import sgd as tsgd
from partsbaseddetector_tpu_torch.train.fit import fit

IMSIZE = (80, 80)
BOXES = np.tile([10.0, 10.0, 70.0, 70.0], (4, 1))
OVERLAP = 0.3
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _tiny_model(seed=0):
    return make_synthetic_model(
        nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=0.0, seed=seed
    )


def _batch():
    rng = np.random.RandomState(0)
    images = rng.rand(4, 80, 80, 3).astype(np.float32) * 255
    labels = np.array([1, -1, 1, -1], dtype=np.float32)
    return images, labels


@pytest.fixture(scope="module")
def setup():
    jm = _tiny_model()
    jp = pack_model(jm)
    tp = tpack(model_from_jax(jm))
    images, labels = _batch()
    return jm, jp, tp, images, labels


def _args(pkg, packed, latent, images, labels):
    if pkg == "jax":
        if latent:
            masks = jsgd.batch_root_masks(packed, IMSIZE, BOXES, OVERLAP)
            return (jnp.asarray(images), masks, jnp.asarray(labels))
        return (jnp.asarray(images), jnp.asarray(labels))
    if latent:
        masks = tsgd.batch_root_masks(packed, IMSIZE, BOXES, OVERLAP, device="cpu")
        return (torch.from_numpy(images), masks, labels)
    return (torch.from_numpy(images), labels)


@pytest.mark.parametrize("latent,want", [(False, 1.128653), (True, 1.316232)])
def test_loss_and_grads_match_jax(setup, latent, want):
    jm, jp, tp, images, labels = setup
    jparams = jsgd.model_params(jm)
    jloss, jgrads = jax.value_and_grad(
        jsgd.make_loss_fn(jp, IMSIZE, latent=latent)
    )(jparams, *_args("jax", jp, latent, images, labels))
    np.testing.assert_allclose(float(jloss), want, atol=1e-5)

    loss_fn = tsgd.make_loss_fn(tp, IMSIZE, latent=latent)
    targs = _args("torch", tp, latent, images, labels)
    tparams = params_from_jax(jparams, device="cpu")
    whole = loss_fn(tparams, *targs)  # the whole batch's graph at once
    whole.backward()
    np.testing.assert_allclose(float(whole.detach()), want, atol=1e-5)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g), **GRAD_TOL)

    # the step's form: one image's graph at a time, grads accumulated
    loss, grads = loss_fn.value_and_grad(tparams, *targs)
    np.testing.assert_allclose(float(loss), want, atol=1e-5)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("latent", [False, True])
def test_three_train_steps_match_jax(setup, latent):
    """Mirrors test_train_parallel.py::test_train_step_decreases_loss."""
    jm, jp, tp, images, labels = setup
    jstep, jopt = jsgd.make_train_step(jp, IMSIZE, latent=latent)
    jparams = jsgd.model_params(jm)
    jstate = jopt.init(jparams)
    tstep, make_opt = tsgd.make_train_step(tp, IMSIZE, latent=latent)
    tparams = params_from_jax(jparams, device="cpu")
    topt = make_opt(tparams.values())
    jargs = _args("jax", jp, latent, images, labels)
    targs = _args("torch", tp, latent, images, labels)
    jlosses, tlosses = [], []
    for _ in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, *jargs)
        tparams, topt, tl = tstep(tparams, topt, *targs)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5)
    assert np.isfinite(tlosses).all() and tlosses[-1] < tlosses[0]
    got = params_to_numpy(tparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **GRAD_TOL)
    d = got["defs"]
    assert (d[:, 0] >= 0.01).all() and (d[:, 2] >= 0.01).all()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_remat_gives_the_same_grads(setup):
    """max_root_score with remat=True recomputes the DP blocks in the
    backward pass and gives the same score and gradients."""
    jm, jp, tp, images, _ = setup
    plan = tpipe.make_plan(tp, IMSIZE)
    dm = to_device(tp, "cpu")
    masks = tpipe.build_root_masks(tp, plan, BOXES[0], OVERLAP)
    got = []
    for remat in (False, True):
        tparams = params_from_jax(jsgd.model_params(jm), device="cpu")
        s = tpipe.max_root_score(
            torch.from_numpy(images[0]), tp, dm, plan, tparams,
            root_masks=masks, remat=remat,
        )
        s.backward()
        got.append((float(s.detach()), {k: v.grad for k, v in tparams.items()}))
    assert got[0][0] == got[1][0]
    for k in got[0][1]:
        assert torch.equal(got[0][1][k], got[1][1][k]), k
        assert bool(got[0][1][k].abs().sum() > 0), k


def test_apply_params_round_trip(setup):
    """Mirrors test_train_parallel.py::test_apply_params_roundtrip, and
    carries the pools both ways between the packages."""
    jm, jp, tp, _, _ = setup
    jparams = jsgd.model_params(jm)
    tparams = params_from_jax(jparams, device="cpu")
    assert all(v.requires_grad and v.is_leaf and v.dtype == torch.float32
               for v in tparams.values())
    for k, v in tsgd.model_params(model_from_jax(jm), device="cpu").items():
        assert torch.equal(v, tparams[k])
    with torch.no_grad():
        for v in tparams.values():
            v += 0.25
    tsgd.project_defs(tparams)
    back = params_to_numpy(tparams)
    want = jsgd.project_defs({k: v + 0.25 for k, v in jparams.items()})
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]))
    model2 = tsgd.apply_params(model_from_jax(jm), tparams)
    jmodel2 = jsgd.apply_params(_tiny_model(), want)
    np.testing.assert_allclose(model2.filters[0], back["filters"][0, :3, :3], atol=1e-6)
    np.testing.assert_allclose(model2.biases, back["biases"], atol=1e-6)
    for a, b in zip(model2.filters + model2.defs, jmodel2.filters + jmodel2.defs):
        np.testing.assert_array_equal(a, b)
    model2.validate()


def test_root_masks_match_jax(setup):
    jm, jp, tp, _, _ = setup
    plan_j = jmake_plan(jp, (96, 120))
    plan_t = tpipe.make_plan(tp, (96, 120))
    bbox = np.array([12.0, 20.0, 70.0, 90.0])
    for want, got in zip(jbuild_root_masks(jp, plan_j, bbox, 0.4),
                         tpipe.build_root_masks(tp, plan_t, bbox, 0.4)):
        np.testing.assert_array_equal(got, want)
    jb = jsgd.batch_root_masks(jp, IMSIZE, BOXES, OVERLAP)
    tb = tsgd.batch_root_masks(tp, IMSIZE, BOXES, OVERLAP, device="cpu")
    assert len(jb) == len(tb)
    for want, got in zip(jb, tb):
        assert got.dtype == torch.bool and got.any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fit_with_checkpoint_and_resume(tmp_path):
    """Mirrors test_train_parallel.py::test_fit_driver_with_checkpoint."""
    model = model_from_jax(_tiny_model(seed=90))
    rng = np.random.RandomState(0)
    images = [(rng.rand(80, 80, 3) * 255).astype(np.float32) for _ in range(8)]
    labels = [1, -1] * 4
    ckpt = str(tmp_path / "ckpt")
    trained, history = fit(
        model, images, labels, epochs=2, batch_size=4,
        checkpoint_dir=ckpt, checkpoint_every=1, device="cpu",
    )
    assert len(history) == 2 and np.isfinite(history).all()
    trained.validate()
    assert not np.array_equal(trained.biases, model.biases)
    # the checkpoint holds the trained pools and the optimizer's momentum
    params = tsgd.model_params(model, device="cpu")
    opt = tsgd.sgd_momentum(params.values())
    params, opt, epoch = tckpt.restore_checkpoint(ckpt, params, opt)
    assert epoch == 2
    np.testing.assert_array_equal(params["biases"].detach().numpy(), trained.biases)
    assert all("momentum_buffer" in s for s in opt.state.values())
    # resume: a fresh fit picks up at epoch 2 and returns immediately
    again, history2 = fit(
        model, images, labels, epochs=2, batch_size=4, checkpoint_dir=ckpt,
        device="cpu",
    )
    assert history2 == []
    np.testing.assert_array_equal(again.biases, trained.biases)


def test_fit_latent_resume_continues_from_the_checkpoint(tmp_path):
    """One epoch with a checkpoint, then a second fit call for two
    epochs: it restores the pools and the momentum and trains only the
    second epoch, in the batch order of a fresh RandomState(seed), as the
    JAX package's fit does. Replaying that by hand gives the same model."""
    model = model_from_jax(_tiny_model(seed=91))
    rng = np.random.RandomState(1)
    images = [(rng.rand(80, 80, 3) * 255).astype(np.float32) for _ in range(4)]
    labels = [1.0, -1.0, 1.0, -1.0]
    kw = dict(bboxes=list(BOXES), overlap=OVERLAP, batch_size=2, seed=3,
              device="cpu")
    ckpt = str(tmp_path / "ckpt")
    _, h1 = fit(model, images, labels, epochs=1, checkpoint_dir=ckpt,
                     checkpoint_every=1, **kw)
    params = tsgd.model_params(model, device="cpu")
    step, make_opt = tsgd.make_train_step(tpack(model), IMSIZE, latent=True)
    opt = make_opt(params.values())
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), params, opt) is None
    params, opt, epoch = tckpt.restore_checkpoint(ckpt, params, opt)
    assert epoch == 1

    resumed, h2 = fit(model, images, labels, epochs=2, checkpoint_dir=ckpt,
                           checkpoint_every=1, **kw)
    assert len(h1) == 1 and len(h2) == 1 and np.isfinite(h1 + h2).all()

    masks = tsgd.batch_root_masks(tpack(model), IMSIZE, BOXES, OVERLAP, device="cpu")
    order = np.random.RandomState(3).permutation(4)
    losses = []
    for i in (0, 2):
        sel = order[i : i + 2]
        params, opt, loss = step(
            params, opt, torch.from_numpy(np.stack(images)[sel]),
            [m[torch.from_numpy(sel)] for m in masks], np.asarray(labels)[sel],
        )
        losses.append(float(loss))
    assert h2 == [float(np.mean(losses))]
    want = tsgd.apply_params(model, params)
    for a, b in zip(resumed.filters + resumed.defs + [resumed.biases],
                    want.filters + want.defs + [want.biases]):
        np.testing.assert_array_equal(a, b)
