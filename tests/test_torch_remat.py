"""The remat policies ``dots`` and ``dots_no_batch`` against the JAX
reference's: the loss and every gradient leaf of reduced configs under
each policy, with bridged weights, at 2e-4; what each policy recomputes,
counted op by op on the CPU (the custom ops' forwards: once a layer
under ``none`` and ``dots``, twice under ``full`` and ``dots_no_batch``,
the launch arithmetic ``chip_smoke.py``'s ``dryrun`` phase asserts on
the card); the port's keep/reuse contexts against torch's own selective
checkpoint; and the trace, which holds the recompute."""
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import (CheckpointPolicy,  # noqa: E402
                                    checkpoint,
                                    create_selective_checkpoint_contexts)

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_map,  # noqa: E402
                              tree_unflatten)

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ["granite-8b", "hubert-xlarge", "jamba-v0.1-52b", "mixtral-8x7b",
         "rwkv6-7b"]
POLICIES = ["dots", "dots_no_batch"]
#: a custom op's forwards a layer and step under each policy
FORWARDS = {"none": 1, "full": 2, "dots": 1, "dots_no_batch": 2}
CUSTOM = ("flash_attention", "wkv6", "selective_scan")
B, S = 2, 16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    full = jcfg.get_config(name)
    # two periods (jamba: one, eight layers): every period is its own
    # checkpoint
    periods = 1 if full.period > 4 else 2
    layers = len(full.prelude) + periods * full.period
    jc = jcfg.reduced(full, layers=layers)
    tc = tcfg.reduced(tcfg.get_config(name), layers=layers)
    jp = jm.init_params(jc, jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    if jc.frontend is not None:
        x = {"embeds": rng.standard_normal((B, S, jc.d_model),
                                           dtype=np.float32) * 0.1}
    else:
        x = {"tokens": rng.integers(0, jc.vocab_size, (B, S), np.int32)}
    batch = {**x,
             "targets": rng.integers(0, jc.vocab_size, (B, S), np.int32)}
    return jc, tc, jp, tp, batch


def _loss_and_grads(cfg, params, batch, policy):
    """The port's loss and its gradient over the per-layer leaves, the
    periods restacked: the reference's tree."""
    unstacked = tm.unstack_periods(cfg, params)
    leaves, structure = tree_flatten(unstacked)
    req = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss, _ = tm.loss_fn(cfg, tree_unflatten(structure, req),
                             {k: torch.as_tensor(v) for k, v in
                              batch.items()}, remat_policy=policy)
        grads = torch.autograd.grad(loss, req, materialize_grads=True)
    g = tree_unflatten(structure, list(grads))
    g["periods"] = tree_map(lambda *xs: torch.stack(xs), *g["periods"])
    return loss.detach(), g


class _Count(TorchDispatchMode):
    """Counts the calls of every op below autograd, by name."""

    def __init__(self):
        super().__init__()
        self.n: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split("::")[1].split(".")[0]
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _counted(cfg, params, batch, policy):
    with _Count() as c:
        loss, grads = _loss_and_grads(cfg, params, batch, policy)
    return loss, grads, c.n


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_reference(model, policy):
    jc, tc, jp, tp, batch = model
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(jc, p, jbatch, remat_policy=policy),
        has_aux=True)(jp)
    loss, grads = _loss_and_grads(tc, tp, batch, policy)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got, want = tree_flatten(grads)[0], jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"leaf {i}")


def test_forward_counts_follow_the_policies(model):
    """Each custom op's forwards a step: once a layer under ``none`` and
    ``dots`` (which keeps its outputs: a product with batch dims), twice
    under ``full`` and ``dots_no_batch``; its backward once a layer
    under all four. The weight products (``mm``) run again only under
    ``full``; every policy gives the same loss and gradients, bit for
    bit."""
    _, tc, _, tp, batch = model
    kinds = list(tc.prelude) + list(tc.block_pattern) * tc.num_periods
    per_layer = {
        "flash_attention": sum(k.startswith(("attn", "swa")) for k in kinds),
        "wkv6": kinds.count("rwkv"),
        "selective_scan": sum(k.startswith("mamba") for k in kinds)}
    loss0, grads0, base = _counted(tc, tp, batch, "none")
    for op in CUSTOM:
        assert base.get(op, 0) == per_layer[op], op
        assert base.get(op + "_bwd", 0) == per_layer[op], op
    for policy in ("full",) + tuple(POLICIES):
        loss, grads, n = _counted(tc, tp, batch, policy)
        for op in CUSTOM:
            assert n.get(op, 0) == FORWARDS[policy] * per_layer[op], \
                (policy, op)
            assert n.get(op + "_bwd", 0) == per_layer[op], (policy, op)
        assert (n["mm"] > base["mm"]) == (policy == "full"), policy
        assert n.get("bmm", 0) >= base.get("bmm", 0)
        if policy == "dots":
            assert n.get("bmm", 0) == base.get("bmm", 0)
        assert torch.equal(loss, loss0)
        for a, b in zip(tree_flatten(grads)[0], tree_flatten(grads0)[0]):
            assert torch.equal(a, b), policy


def _torch_sac(saved):
    """torch's selective checkpoint with the same policy."""
    return create_selective_checkpoint_contexts(
        lambda ctx, func, *a, **k: CheckpointPolicy.MUST_SAVE
        if func.name() in saved else CheckpointPolicy.PREFER_RECOMPUTE)


@pytest.mark.parametrize("policy", POLICIES)
def test_contexts_run_what_torch_selective_checkpoint_runs(policy,
                                                           monkeypatch):
    """Run eagerly, the port's keep/reuse contexts and torch's
    ``create_selective_checkpoint_contexts`` with the same policy run the
    same ops and give the same loss and gradients, bit for bit (mixtral:
    weight products and products with batch dims)."""
    cfg = tcfg.reduced(tcfg.get_config("mixtral-8x7b"), layers=2)
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = tm.smoke_batch(cfg, seq=16, device="cpu")
    batch["tokens"] = torch.randint(0, cfg.vocab_size, (2, 16),
                                    generator=torch.Generator()
                                    .manual_seed(3), dtype=torch.int32)
    ours = _counted(cfg, params, batch, policy)
    monkeypatch.setattr(transformer, "_remat_contexts", _torch_sac)
    theirs = _counted(cfg, params, batch, policy)
    assert ours[2] == theirs[2]
    assert torch.equal(ours[0], theirs[0])
    for a, b in zip(tree_flatten(ours[1])[0], tree_flatten(theirs[1])[0]):
        assert torch.equal(a, b)


def test_trace_holds_the_recompute():
    """A step traced on fake tensors (``api.trace(..., autograd=True)``)
    holds what the policy recomputes: each custom op's forward nodes are
    the eager step's calls; against ``none``'s graph, ``dots`` adds no
    product, ``dots_no_batch`` the products with batch dims (mixtral's
    ``bmm``), ``full`` the weight products too."""
    cfg = tcfg.reduced(tcfg.get_config("mixtral-8x7b"), layers=2)
    params = tm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = tm.smoke_batch(cfg, seq=16, device="cpu")
    count = {}
    for policy in ("none", "full") + tuple(POLICIES):
        _, _, eager = _counted(cfg, params, batch, policy)
        traced = api.trace(partial(_loss_and_grads, cfg, policy=policy),
                           params, batch, autograd=True)
        names = traced.graph.names
        count[policy] = {op: names.count(op) for op in ("mm", "bmm")}
        for op in ("flash_attention", "flash_attention_bwd"):
            assert names.count(op) == eager[op] > 0, (policy, op)
    none = count["none"]
    assert count["dots"] == none
    assert count["dots_no_batch"]["mm"] == none["mm"]
    assert count["full"]["mm"] > none["mm"]
    for policy in ("full", "dots_no_batch"):
        assert count[policy]["bmm"] > none["bmm"] > 0


def test_an_output_written_in_place_after_it_was_kept_raises():
    """The recompute hands back what the forward kept; a kept product
    output that was written in place since raises instead of feeding a
    stale value to the backward."""
    w = torch.randn(4, 4, requires_grad=True)

    def f(x):
        y = x @ w
        y.add_(1.0)
        return (y * y).sum()

    loss = checkpoint(f, torch.randn(3, 4), use_reentrant=False,
                      context_fn=partial(transformer._remat_contexts,
                                         transformer._SAVED["dots"]))
    with pytest.raises(RuntimeError, match="written in place"):
        loss.backward()
