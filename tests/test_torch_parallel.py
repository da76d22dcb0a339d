"""The port's parallel/ (torch.distributed) against one process and
against the JAX package's parallel/, on the CPU.

Several ranks are rehearsed as multi-process gloo runs: each rank is a
fresh process started with a spawn context, with torchrun's WORLD_SIZE,
RANK and LOCAL_RANK, joined by initialize_distributed over a file store
in the test's tmp_path, with one torch thread; a rank that dies or outlives
JOIN_S seconds fails the test and the others are stopped. This module's
top level imports no JAX, because every rank imports it again; the JAX
side runs in the test process, on the 8 virtual CPU devices of
tests/conftest.py. Mirrors tests/test_train_parallel.py:

  - detection, world 2 (dp=2): batched_detect_fn's gathered outputs
    equal detect_batch_fn's on the whole batch bit for bit, for both
    engines (one case each), whether the batch comes whole or as a dp-sharded DTensor.
    Against the JAX package's batched_detect_fn on a 4-device mesh:
    valid rows equal, spatial scores within rtol 1e-5, atol 1e-5 and
    boxes within rtol 1e-5, atol 1e-4 (test_batched_detect_matches_single's
    bounds), Fourier scores within 2e-3 and boxes within 5e-2
    (tests/test_torch_fourier.py's JAX bounds);
  - training, world 4 as dp=2 x tp=2 and as dp=1 x tp=4 (F = 6 filters,
    not a multiple of 4: padded with zero filters): after one step the
    loss and the gathered pools equal the port's single-process
    make_train_step on the whole batch, and the JAX package's
    sharded_train_step on its (4, 2) mesh, within loss rtol 1e-4 and
    pools rtol 1e-4, atol 1e-5 (test_sharded_train_step_runs's bounds);
  - the single-process helpers with no launcher environment.
"""

import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from partsbaseddetector_tpu_torch import PartsBasedDetector, parallel
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model, pack_model
from partsbaseddetector_tpu_torch.train import sgd

JOIN_S = 120
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
TRAIN_MESHES = ((2, 2), (1, 4))
LOSS_TOL = dict(rtol=1e-4)
POOL_TOL = dict(rtol=1e-4, atol=1e-5)


def _tiny_model(seed=0, thresh=0.0):
    return make_synthetic_model(
        nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=thresh, seed=seed
    )


def _detect_batch():
    rng = np.random.RandomState(2)
    return rng.rand(4, 80, 80, 3).astype(np.float32) * 255


def _train_batch():
    rng = np.random.RandomState(1)
    images = rng.rand(8, 80, 80, 3).astype(np.float32) * 255
    labels = (rng.rand(8) > 0.5).astype(np.float32) * 2 - 1
    return images, labels


def _rank(target, rank, world, init, out_dir, args):
    """One spawned rank: the launcher's environment (as torchrun sets
    WORLD_SIZE, RANK and LOCAL_RANK; the rendezvous is the file store),
    joined through initialize_distributed, then target."""
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    assert parallel.initialize_distributed(init_method=init, device="cpu") is True
    assert dist.get_backend() == "gloo" and dist.get_rank() == rank
    try:
        target(rank, out_dir, *args)
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules


def _launch(target, world, tmp_path, *args):
    """Run target(rank, out_dir, *args) in `world` spawned gloo ranks;
    fail if any rank fails or the group outlives JOIN_S."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [
        ctx.Process(target=_rank, args=(target, r, world, init, str(tmp_path), args))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    assert [p.exitcode for p in procs] == [0] * world


def _detect_rank(rank, out_dir, engine):
    model = _tiny_model(seed=3, thresh=-5.0)
    mesh = parallel.make_mesh(dp=2, tp=1, device="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp")
    batch = torch.from_numpy(_detect_batch())
    det = PartsBasedDetector(model, max_detections=16, conv_engine=engine,
                             device="cpu")
    fn = parallel.batched_detect_fn(det, (80, 80), mesh)
    spectra = dict(det._spectra)
    want = det.detect_batch_fn((80, 80), 4)(batch)
    got = fn(batch)
    local = parallel.host_local_batch_to_global(mesh, batch[2 * rank : 2 * rank + 2])
    got_local = fn(local)
    for g, gl, w in zip(got, got_local, want):
        assert g.to_local().shape[0] == 2
        assert torch.equal(g.full_tensor(), w)
        assert torch.equal(gl.to_local(), w[2 * rank : 2 * rank + 2])
    # the Fourier spectra went up once, when fn was built
    assert len(spectra) == (engine == "fourier")
    assert all(det._spectra[k] is v for k, v in spectra.items())
    if rank == 0:
        np.savez(os.path.join(out_dir, f"detect_{engine}.npz"),
                 *[t.numpy() for t in want])


def _train_rank(rank, out_dir, dp, tp):
    model = _tiny_model()
    packed = pack_model(model)
    images, labels = _train_batch()
    images = torch.from_numpy(images)
    step1, make_opt = sgd.make_train_step(packed, (80, 80))
    ref = sgd.model_params(model, device="cpu")
    ref, _, ref_loss = step1(ref, make_opt(ref.values()), images, labels)
    mesh = parallel.make_mesh(dp=dp, tp=tp, device="cpu")
    step, make_opt, shard = parallel.sharded_train_step(packed, (80, 80), mesh)
    params = shard(sgd.model_params(model, device="cpu"))
    assert params["filters"].shape[0] == -(-6 // tp)
    params, _, loss = step(params, make_opt(params.values()), images, labels)
    full = shard.gather(params)
    np.testing.assert_allclose(float(loss), float(ref_loss), **LOSS_TOL)
    for k, v in full.items():
        assert v.shape == ref[k].shape
        np.testing.assert_allclose(v.numpy(), ref[k].detach().numpy(), **POOL_TOL)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"train_{dp}x{tp}.npz"), loss=float(loss),
                 **{k: v.numpy() for k, v in full.items()})


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("engine", ["spatial", "fourier"])
def test_batched_detect_world2_matches_one_process_and_jax(tmp_path, no_launcher, engine):
    import jax.numpy as jnp

    from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
    from partsbaseddetector_tpu.models.model import make_synthetic_model as jmodel
    from partsbaseddetector_tpu.parallel.mesh import batched_detect_fn, make_mesh

    _launch(_detect_rank, 2, tmp_path, engine)
    jm = jmodel(nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=-5.0,
                seed=3)
    batch = jnp.asarray(_detect_batch())
    score_tol, box_tol = {
        "spatial": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-4)),
        "fourier": (dict(rtol=0, atol=2e-3), dict(rtol=0, atol=5e-2)),
    }[engine]
    det = JaxDetector(jm, max_detections=16, conv_engine=engine)
    want = [np.asarray(t) for t in
            batched_detect_fn(det, (80, 80), make_mesh(n_devices=4, dp=4))(batch)]
    got = np.load(tmp_path / f"detect_{engine}.npz")
    boxes, scores, comps, valid, mix = (got[f"arr_{i}"] for i in range(5))
    np.testing.assert_array_equal(valid, want[3])
    assert valid.any()
    np.testing.assert_allclose(scores[valid], want[1][valid], **score_tol)
    np.testing.assert_allclose(boxes[valid], want[0][valid], **box_tol)
    np.testing.assert_array_equal(comps[valid], want[2][valid])
    np.testing.assert_array_equal(mix[valid], want[4][valid])


@pytest.mark.parametrize("dp,tp", TRAIN_MESHES)
def test_sharded_train_step_world4_matches_one_process_and_jax(tmp_path, no_launcher, dp, tp):
    import jax
    import jax.numpy as jnp

    from partsbaseddetector_tpu.models.model import make_synthetic_model as jmodel
    from partsbaseddetector_tpu.models.model import pack_model as jpack
    from partsbaseddetector_tpu.parallel.mesh import make_mesh, sharded_train_step
    from partsbaseddetector_tpu.train.sgd import model_params

    _launch(_train_rank, 4, tmp_path, dp, tp)
    jm = jmodel(nparts=3, nmix=2, fsize=(3, 3), sbin=8, interval=2, thresh=0.0, seed=0)
    mesh = make_mesh(n_devices=8, dp=4, tp=2)
    step, opt, shard_params = sharded_train_step(jpack(jm), (80, 80), mesh)
    params = shard_params(model_params(jm))
    images, labels = _train_batch()
    with mesh:
        want, _, wloss = step(params, opt.init(params), jnp.asarray(images),
                              jnp.asarray(labels))
    want = jax.tree.map(np.asarray, want)
    got = np.load(tmp_path / f"train_{dp}x{tp}.npz")
    np.testing.assert_allclose(float(got["loss"]), float(wloss), **LOSS_TOL)
    for k in ("filters", "defs", "biases"):
        np.testing.assert_allclose(got[k], want[k], **POOL_TOL)


def test_distributed_helpers_single_process(no_launcher):
    """With no launcher environment initialize_distributed does
    nothing, the global mesh is the 1x1 mesh over a single-rank group,
    and the distributed detect and train step run as one process's."""
    from torch.distributed.tensor import DTensor

    assert not dist.is_initialized()
    assert parallel.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    try:
        mesh = parallel.make_global_mesh(tp=1, device="cpu")
        assert dist.get_world_size() == 1
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
        with pytest.raises(AssertionError):
            parallel.make_global_mesh(tp=2, device="cpu")

        model = _tiny_model()
        det = PartsBasedDetector(model, max_detections=8, device="cpu")
        run, mesh2 = parallel.distributed_batched_detect_fn(det, (64, 64), tp=1)
        assert mesh2.shape == (1, 1)
        batch = (np.random.RandomState(0).rand(8, 64, 64, 3) * 255).astype(np.float32)
        out = run(batch)
        want = det.detect_batch_fn((64, 64), 8)(torch.from_numpy(batch))
        assert out[0].shape[0] == 8
        for o, w in zip(out, want):
            assert torch.equal(o.full_tensor(), w)

        g = parallel.host_local_batch_to_global(mesh, np.zeros((8, 4), np.float32))
        assert isinstance(g, DTensor) and g.shape == (8, 4)
        assert g.placements[0].is_shard(0)

        packed = pack_model(model)
        step, make_opt, shard, mesh3 = parallel.distributed_train_step(
            packed, (80, 80), device="cpu")
        images, labels = _train_batch()
        params = shard(sgd.model_params(model, device="cpu"))
        _, _, loss = step(params, make_opt(params.values()), images[:2], labels[:2])
        ref_step, ref_opt = sgd.make_train_step(packed, (80, 80))
        ref = sgd.model_params(model, device="cpu")
        ref, _, ref_loss = ref_step(ref, ref_opt(ref.values()),
                                    torch.from_numpy(images[:2]), labels[:2])
        np.testing.assert_allclose(float(loss), float(ref_loss), **LOSS_TOL)
        for k, v in shard.gather(params).items():
            np.testing.assert_allclose(v.numpy(), ref[k].detach().numpy(), **POOL_TOL)
    finally:
        dist.destroy_process_group()


def test_nccl_is_asked_for_on_the_card_and_gloo_only_on_the_cpu():
    """The backend follows the device; no device falls back to another."""
    assert parallel.mesh.backend_for(torch.device("cuda")) == "nccl"
    assert parallel.mesh.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError):
        parallel.mesh.backend_for(torch.device("meta"))


def test_the_entry_points_default_to_the_card(monkeypatch, no_launcher):
    """Without a CUDA device the default mesh raises at once and sets up
    no process group; the examples' default device raises too."""
    from partsbaseddetector_tpu_torch.examples import rgbd_serving_demo, training_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (parallel.make_mesh, parallel.make_global_mesh,
                 lambda: rgbd_serving_demo.main([]),
                 lambda: training_demo.main(["--fast"])):
        with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
            call()
    assert not dist.is_initialized()
