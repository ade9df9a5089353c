"""What lets the port's distill step and its block-remat train step be
captured as CUDA graphs, on the CPU (MINI, f32, EMA on): the distill
step's body (both solver loops, the loss, the backward, clip + AdamW,
write-back, EMA) makes no tensor from host data and waits on nothing, with
the student's solver remat on and off; the train step's body with block
remat and dropout 0.1 does neither, and its gradients equal the plain
step's under the same generator; the distill signature tells apart what a
captured step is specific to; and the graph path is never taken on CPU
tensors. The capture and replay themselves run on the card
(tests/test_torch_kernels_cuda.py); the port's distill step against the
JAX package's jitted one is in tests/test_torch_distill.py."""

import dataclasses

import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.train import distill, steps
from ddpm_image_restoration_tpu_torch.utils.graphs import GraphCache
from tests._tiny import MINI
from tests._torch_parity import smooth_images
from tests.test_torch_graph import _NoHostData, _no_from_numpy
from tests.test_torch_train_graph import _guarded_body, _setup

torch.set_num_threads(1)

STATE_PARTS = ("params", "mu", "nu", "ema")
# q30 over 20 diffusion steps (init_t 20): the teacher at stride 10 (3
# evaluations), the student at 2 (stride 19), as tests/test_torch_distill.py
QUALITY, DCFG = 30, dict(n_eval=2, teacher_stride=10)


def _distill_setup(remat: bool = True, quality: int = QUALITY, cache=None, **dcfg):
    """A MINI f32 teacher and a student holding its weights (dropout 0),
    the student's train state (EMA on), one bucket's step and a batch of
    2."""
    mcfg = ModelConfig(**{**dataclasses.asdict(MINI), "dropout": 0.0})
    torch.manual_seed(2)
    teacher = build_model("webp", mcfg, device="cpu")
    student = build_model("webp", mcfg, device="cpu")
    student.load_state_dict(teacher.state_dict())
    cfg = TrainConfig(codec="webp", model=mcfg, steps=20, ema_decay=0.999)
    state = steps.create_train_state(student, cfg)
    step, *_ = distill.make_distill_step(student, teacher, cfg,
                                         distill.DistillConfig(**{**DCFG, **dcfg}), quality,
                                         remat=remat, cache=cache)
    x0 = smooth_images(2, MINI.image_size, seed=11)
    xt = np.clip(x0 + np.random.default_rng(1).normal(0, 0.08, x0.shape), -1, 1)
    batch = {"x0": torch.from_numpy(x0), "xt": torch.from_numpy(xt.astype(np.float32))}
    return teacher, student, state, step, batch


def _assert_same_runs(want, got, state0, state1):
    for w, g in zip(want, got):
        assert torch.equal(w["loss"], g["loss"]) and torch.equal(w["grad_norm"], g["grad_norm"])
    for part in STATE_PARTS:
        for k, v in getattr(state0, part).items():
            assert torch.equal(v, getattr(state1, part)[k]), (part, k)


@pytest.mark.parametrize("remat", [True, False])
def test_distill_body_makes_no_tensor_from_host_data(monkeypatch, remat):
    """Two distill steps, the student's solver remat on and off: the body
    under `_NoHostData` (torch.from_numpy replaced too) gives, bit for bit,
    the loss, grad norm, masters, moments and EMA of the same steps run
    without it (the first call fills the device-constant caches, as a
    signature's eager first call does on the card)."""
    body = distill._step_body
    runs = []
    for guard in (False, True):
        teacher, student, state, step, batch = _distill_setup(remat)
        entered = []
        if guard:
            def guarded(*a, **k):
                entered.append(True)
                with pytest.MonkeyPatch.context() as mp, _NoHostData():
                    mp.setattr(torch, "from_numpy", _no_from_numpy)
                    return body(*a, **k)

            monkeypatch.setattr(distill, "_step_body", guarded)
        metrics = [step(state, batch) for _ in range(2)]
        assert entered == ([True, True] if guard else [])
        runs.append((metrics, state, student))
    (want, s0, m0), (got, s1, m1) = runs
    _assert_same_runs(want, got, s0, s1)
    for (n, p), (_, q) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
    assert s1.step == 2 and len(set(m["loss"].item() for m in got)) == 2
    assert all(p.grad is None for p in teacher.parameters())


def test_remat_train_body_with_dropout(monkeypatch):
    """The train step with block remat and dropout 0.1 (the mask drawn
    before each block's checkpoint): its body under `_NoHostData` gives,
    bit for bit, the unguarded step's loss, grad norm, masters, moments and
    EMA over two steps, and those equal the plain (no remat) step's under a
    generator seeded alike, as do the last step's `.grad` and the
    generator's state after."""
    runs = []
    for remat, guard in ((False, False), (True, False), (True, True)):
        model, cfg, state, batch = _setup("webp", remat=remat)
        assert cfg.model.dropout == 0.1 and model.cfg.remat == remat
        step, gen = steps.make_train_step(model, cfg), torch.Generator().manual_seed(1)
        entered = []
        if guard:
            _guarded_body(monkeypatch, entered)
        metrics = [step(state, batch, gen) for _ in range(2)]
        assert entered == ([True, True] if guard else [])
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        runs.append((metrics, state, grads, gen.get_state()))
    plain = runs[0]
    for metrics, state, grads, gen_state in runs[1:]:
        _assert_same_runs(plain[0], metrics, plain[1], state)
        assert all(torch.equal(plain[2][n], g) for n, g in grads.items())
        assert torch.equal(plain[3], gen_state)
    assert plain[2]["down1.conv2.weight"].abs().max() > 0


def _key(monkeypatch, remat=True, quality=QUALITY, batch_rows=2, **dcfg):
    """The signature the step computes for this setup (the graph path
    forced on, so that the CPU call records it as a first call)."""
    monkeypatch.setattr(distill, "_graphed", lambda state, batch: True)
    cache = GraphCache(2)
    _, _, state, step, batch = _distill_setup(remat, quality, cache, **dcfg)
    step(state, {k: v[:batch_rows] for k, v in batch.items()})
    assert step.cache is cache and not cache.graphs
    (key,) = cache.seen
    return key


def _settings(key):
    """A key without the objects and addresses (the student and teacher,
    their weights, the state's tensors), which differ between builds: of
    `train/steps.py state_signature` the items from the batch on, then the
    teacher's compute dtype and mode, the generator and the bucket's
    settings."""
    return key[7:13] + key[15:]


def test_distill_signature_tells_apart_what_a_graph_is_specific_to(monkeypatch):
    """Between builds of the same setup only the objects and addresses
    differ; the settings differ with the quality (another init_t), either
    stride, remat and the batch's shape. Within one step function, another
    batch of the same shape and an in-place update of the masters, moments
    and EMA give the same key; a reassigned student or teacher parameter
    another."""
    base = _key(monkeypatch)
    assert _settings(_key(monkeypatch)) == _settings(base)
    for other in (_key(monkeypatch, quality=50), _key(monkeypatch, teacher_stride=5),
                  _key(monkeypatch, n_eval=3), _key(monkeypatch, remat=False),
                  _key(monkeypatch, batch_rows=1)):
        assert _settings(other) != _settings(base)

    cache = GraphCache(2)
    teacher, student, state, step, batch = _distill_setup(cache=cache)
    step(state, batch)
    (first,) = cache.seen
    keys, real = [], distill._signature

    def recording(*a):  # the key of a call that would capture, then stop
        keys.append(real(*a))
        raise RuntimeError("stop before the capture")

    monkeypatch.setattr(distill, "_signature", recording)

    def key_of(b):
        with pytest.raises(RuntimeError, match="stop before"):
            step(state, b)
        return keys[-1]

    with torch.no_grad():
        for part in STATE_PARTS:
            next(iter(getattr(state, part).values())).add_(1.0)
    assert key_of({k: v.flip(0) for k, v in batch.items()}) == first
    for model in (student, teacher):
        model.out_conv.weight = torch.nn.Parameter(model.out_conv.weight.detach().clone(),
                                                   requires_grad=model is student)
        assert key_of(batch) != first


def test_distill_graph_path_never_on_cpu_tensors(monkeypatch):
    """On CPU tensors the step runs eager, computes no signature and keeps
    no graph; `step.eager` and the step give the same results."""
    def no_signature(*a, **k):
        raise AssertionError("a signature computed for a CPU run")

    monkeypatch.setattr(distill, "_signature", no_signature)
    results = []
    for use_eager in (False, True):
        _, _, state, step, batch = _distill_setup()
        fn = step.eager if use_eager else step
        results.append(([fn(state, batch) for _ in range(2)], state))
        assert not step.cache.seen and not step.cache.graphs and state.step == 2
    (want, s0), (got, s1) = results
    _assert_same_runs(want, got, s0, s1)
