"""K5/K6, the fused edge attention, and ``use_pallas`` in the PyTorch port.

The port's plain versions of the forward and backward kernels (what its
wrappers run for a CPU tensor) are held against the JAX package's Pallas
kernels (``_fwd3_pallas``, ``_bwd3_pallas``) run through the interpreter on
the same numpy inputs, at the JAX attention tests' own sizes (dim 128,
8 heads, N 7-9, batch 2: the smallest that reach the kernel, since the
routing rule sends a width that is not a multiple of 128 to the jnp path).
Tolerances: f32 1e-5 (same products, f32 sums in another order; read up to
1.2e-5 on weight gradients of |g| ~ 40, so those by relative norm 1e-5);
bf16 outputs (compared in f32) one bf16 rounding apart, atol 1e-2 + rtol
2^-7 (a sum in another order can round to the neighbouring bf16 value);
the weight gradients are f32 sums in both, relative norm 1e-5.  The routing
rule is compared with the one the JAX op takes (observed under
``jax.eval_shape``), and ``GraphMHA`` / ``EncoderBlock`` with ``use_pallas``
against flax from converted weights (f32: 1e-4, two projections and a
softmax of f32 sums in another order; gradients 1e-4 relative).  The
numerics ladder turns the fused attention off at tiers 2 and 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, write_corpus
from druggen_tpu.models.layers import EncoderBlock as FlaxEncoderBlock
from druggen_tpu.models.layers import GraphMHA as FlaxGraphMHA
from druggen_tpu.ops import fused_attention as jax_fa
from druggen_tpu_torch.config import parse_train_args
from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.models import EncoderBlock, GraphMHA
from druggen_tpu_torch.ops import fused_attention as port
from druggen_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

B, N, D, HEADS = 2, 7, 128, 8
NAMES_FWD = ("edge_out", "node_agg", "t")
NAMES_BWD = ("dq", "dk", "dv", "d_eraw", "dwe", "dbe", "dwoe", "dboe")


def _inputs(seed, n=N):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    acts = [arr(B, n, D), arr(B, n, D), arr(B, n, D), arr(B, n, n, D)]
    params = [arr(D, D, scale=D ** -0.5), arr(D, scale=0.1),
              arr(D, D, scale=D ** -0.5), arr(D, scale=0.1)]
    cot = [arr(B, n, n, D), arr(B, n, D)]
    return acts, params, cot


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close(got, want, dtype, name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    if name.startswith("dw") or name.startswith("db"):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (name, rel)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7, err_msg=name)


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "bf16"])
def pallas_run(request):
    """One interpreted Pallas forward and backward on numpy inputs."""
    tdt, jdt = request.param
    acts, params, (ge, gn) = _inputs(0)
    ja = [jnp.asarray(x, jdt) for x in acts]
    jp = [jnp.asarray(x) for x in params]
    fwd = jax_fa._fwd3_pallas(*ja, *jp, D // HEADS, True)
    bwd = jax_fa._bwd3_pallas(*ja, *jp[:3], fwd[2], jnp.asarray(ge, jdt),
                              jnp.asarray(gn, jdt), D // HEADS, True)
    return tdt, acts, params, (ge, gn), fwd, bwd


def test_plain_fwd_matches_pallas(pallas_run):
    tdt, acts, params, _, fwd, _ = pallas_run
    got = port.edge_attention_fwd(*[torch.from_numpy(x).to(tdt) for x in acts],
                                  *[torch.from_numpy(p) for p in params], HEADS)
    for name, g, w in zip(NAMES_FWD, got, fwd):
        assert g.dtype == tdt, name
        _close(g, w, tdt, name)


def test_plain_bwd_matches_pallas(pallas_run):
    """The backward from the Pallas forward's own rounded t residual."""
    tdt, acts, params, (ge, gn), fwd, bwd = pallas_run
    t_res = torch.from_numpy(_f32(fwd[2])).to(tdt)
    got = port.edge_attention_bwd(
        *[torch.from_numpy(x).to(tdt) for x in acts],
        *[torch.from_numpy(p) for p in params[:3]], t_res,
        torch.from_numpy(ge).to(tdt), torch.from_numpy(gn).to(tdt), HEADS)
    for i, (name, g, w) in enumerate(zip(NAMES_BWD, got, bwd)):
        assert g.dtype == (tdt if i < 4 else torch.float32), name
        _close(g, w, tdt, name)


def test_op_gradients_match_jax():
    """The autograd Function (K5 forward, K6 backward; their plain versions
    here) against ``jax.grad`` through the JAX op's ``custom_vjp`` in the
    interpreter: all eight input gradients, f32."""
    acts, params, (wo, wn) = _inputs(1, n=9)
    shaped = [acts[0].reshape(B, 9, HEADS, D // HEADS),
              acts[1].reshape(B, 9, HEADS, D // HEADS),
              acts[2].reshape(B, 9, HEADS, D // HEADS), acts[3]]

    def loss(*args):
        eo, na = jax_fa.edge_modulated_attention_proj(*args, interpret=True)
        return jnp.sum(eo * wo) + jnp.sum(na * wn)

    want = jax.grad(loss, argnums=tuple(range(8)))(
        *[jnp.asarray(x) for x in shaped + params])
    leaves = [torch.from_numpy(x).requires_grad_() for x in shaped + params]
    calls = []
    orig = port.EdgeAttentionProj.apply
    port.EdgeAttentionProj.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        eo, na = port.edge_modulated_attention_proj(*leaves)
    finally:
        port.EdgeAttentionProj.apply = orig
    assert calls == [1]
    (eo * torch.from_numpy(wo)).sum().add((na * torch.from_numpy(wn)).sum()).backward()
    for name, leaf, w in zip(("q", "k", "v", "eraw", "we", "be", "woe", "boe"),
                             leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


# The limit that chip_smoke.py and test_torch_port_card.py hold K6's bf16
# gradients to against its plain version (relative norm error).
K6_BF16_GRAD_REL = 1e-3
_PLANTS = {
    "e": ("e = (er @ we32 + be.to(f32)).reshape(b, n, n, d)",
          "e = (er @ we32 + be.to(f32)).reshape(b, n, n, d).bfloat16().float()"),
    "de": ("de2 = de.reshape(-1, d)", "de2 = de.reshape(-1, d).bfloat16().float()"),
    "dt": ("dbase = dtt * ", "dtt = dtt.bfloat16().float()\n    dbase = dtt * "),
}


@pytest.mark.parametrize("plant", sorted(_PLANTS))
def test_k6_bf16_limit_catches_rounded_intermediates(plant):
    """A K6 that rounded e, de or the upstream gradient dt to bf16 (where the
    Pallas kernel keeps f32) reads past the card's bf16 limit against the
    plain version, at the training N and D (on the card the kernel reads at
    most 2.7e-5)."""
    import inspect
    src = inspect.getsource(port.edge_attention_bwd_reference)
    old, new = _PLANTS[plant]
    assert src.count(old) == 1
    scope = dict(vars(port))
    exec(src.replace(old, new), scope)
    planted = scope["edge_attention_bwd_reference"]
    gen = torch.Generator().manual_seed(7)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    b, n, dt = 4, 45, torch.bfloat16
    acts = [r(b, n, D).to(dt) for _ in range(3)] + [r(b, n, n, D).to(dt)]
    params = [r(D, D, scale=D ** -0.5), r(D, scale=0.1), r(D, D, scale=D ** -0.5),
              r(D, scale=0.1)]
    ge, gn = r(b, n, n, D).to(dt), r(b, n, D).to(dt)
    t_res = port.edge_attention_fwd_reference(*acts, *params, HEADS)[2]
    args = (*acts, *params[:3], t_res, ge, gn, HEADS)
    ref = port.edge_attention_bwd_reference(*args)
    rels = [((g.float() - w.float()).norm() / w.float().norm()).item()
            for g, w in zip(planted(*args), ref)]
    assert max(rels) > 2 * K6_BF16_GRAD_REL, rels


def test_backward_is_first_order_only():
    acts, params, _ = _inputs(2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in acts + params]
    eo, _ = port.EdgeAttentionProj.apply(*leaves, HEADS)
    (gq,) = torch.autograd.grad(eo.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[4])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_routing_rule_matches_jax(dtype, monkeypatch):
    """Over a grid of (N, D): the port's rule sends a shape to the kernel
    exactly when the JAX op takes its Pallas custom_vjp."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    taken = []

    def fake_op(n, h, dk, interpret, dtype_name):
        taken.append(True)
        return lambda q3, k3, v3, eraw, *w: (eraw, q3)

    monkeypatch.setattr(jax_fa, "_make_proj_op", fake_op)
    sent = 0
    for n in (7, 9, 40, 41, 45, 46, 48, 49, 56, 57, 69, 70, 81, 82, 99, 100):
        for d in (32, 64, 96, 128, 256, 384, 512):
            h = 8
            taken.clear()
            spec = jax.ShapeDtypeStruct
            jax.eval_shape(
                lambda *a: jax_fa.edge_modulated_attention_proj(*a, interpret=True),
                spec((1, n, h, d // h), jdt), spec((1, n, h, d // h), jdt),
                spec((1, n, h, d // h), jdt), spec((1, n, n, d), jdt),
                spec((d, d), jnp.float32), spec((d,), jnp.float32),
                spec((d, d), jnp.float32), spec((d,), jnp.float32))
            assert port.uses_kernel(n, d, dtype) == bool(taken), (n, d)
            sent += bool(taken)
    assert 0 < sent
    # the training shape: N 45 reaches the kernel at every D up to 512 in
    # bf16 and up to 384 in f32
    assert [port.uses_kernel(45, d, dtype) for d in (128, 256, 384, 512)] == (
        [True] * 4 if dtype == torch.bfloat16 else [True, True, True, False])


def test_port_op_takes_the_plain_composite_where_the_rule_says():
    """D 32 goes to ``reference_attention_proj``, with jnp's promotion: a
    bf16 stream against the f32 weights comes out f32, as in JAX."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, N, 4, 8)).astype(np.float32))
               .bfloat16() for _ in range(3))
    eraw = torch.from_numpy(rng.normal(size=(B, N, N, 32)).astype(np.float32)).bfloat16()
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
         for s in ((32, 32), (32,), (32, 32), (32,))]
    eo, na = port.edge_modulated_attention_proj(q, k, v, eraw, *w)
    jeo, jna = jax_fa.edge_modulated_attention_proj(
        *[jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v, eraw)],
        *[jnp.asarray(x.numpy()) for x in w], interpret=True)
    assert eo.dtype == na.dtype == torch.float32
    assert jeo.dtype == jna.dtype == jnp.float32
    np.testing.assert_allclose(eo.numpy(), np.asarray(jeo), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(na.numpy(), np.asarray(jna), atol=1e-2, rtol=1e-2)


# --- modules against flax ----------------------------------------------------

def _module_inputs(n):
    rng = np.random.default_rng(4)
    return (rng.normal(size=(B, n, D)).astype(np.float32),
            rng.normal(size=(B, n, n, D)).astype(np.float32))


def _flat_grads(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_module(flax_mod, to_torch, port_mod, n):
    """Outputs and the input and parameter gradients of a loss of both
    outputs, port (plain K5/K6 through autograd) against flax (Pallas in the
    interpreter, ``custom_vjp``), from one flax init."""
    node, edge = _module_inputs(n)
    variables = flax_mod.init(jax.random.PRNGKey(5), node, edge)
    rng = np.random.default_rng(6)
    wn = rng.normal(size=(B, n, D)).astype(np.float32)
    we = rng.normal(size=(B, n, n, D)).astype(np.float32)

    def loss(params, x, y):
        no, eo = flax_mod.apply(params, x, y)
        return jnp.sum(no * wn) + jnp.sum(eo * we)

    want_out = flax_mod.apply(variables, node, edge)
    want_g, want_x, want_y = jax.grad(loss, argnums=(0, 1, 2))(variables, node, edge)
    port_mod.load_state_dict(weights.to_torch_tensors(to_torch(variables)))
    port_mod.eval()
    x, y = (torch.from_numpy(a).requires_grad_() for a in (node, edge))
    no, eo = port_mod(x, y)
    for g, w in zip((no, eo), want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    ((no * torch.from_numpy(wn)).sum() + (eo * torch.from_numpy(we)).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-4)
    grads_sd = to_torch(jax.tree_util.tree_map(np.asarray, want_g))
    for name, p in port_mod.named_parameters():
        w = grads_sd[name]
        rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (name, rel)


def test_graph_mha_use_pallas_matches_flax():
    _check_module(FlaxGraphMHA(D, HEADS, use_pallas=True), weights.flax_mha_to_torch,
                  GraphMHA(D, HEADS, use_pallas=True), n=9)


def test_encoder_block_use_pallas_and_fused_mlp_matches_flax():
    _check_module(FlaxEncoderBlock(D, HEADS, 3, use_pallas=True, fused_mlp=True),
                  weights.flax_encoder_block_to_torch,
                  EncoderBlock(D, HEADS, 3, use_pallas=True, fused_mlp=True), n=7)


def test_use_pallas_with_f32_stats_raises():
    mha = GraphMHA(D, HEADS, torch.bfloat16, f32_stats=True, use_pallas=True)
    node, edge = (torch.from_numpy(a) for a in _module_inputs(N))
    with pytest.raises(ValueError, match="f32_stats"):
        mha(node, edge)


# --- the numerics ladder -----------------------------------------------------

def test_ladder_turns_the_fused_attention_off_at_tiers_2_and_3(tmp_path, monkeypatch):
    """``--use_pallas`` trains (it no longer raises): the Generator's
    attention goes through the fused op (its plain versions here) at tiers
    0 and 1, and not at tier 2 (f32 softmax) or tier 3 (full f32), on the
    same parameters; the critic never takes it."""
    write_corpus(str(tmp_path / "chembl.smi"), DRUGLIKE_SMILES)
    write_corpus(str(tmp_path / "drugs.smi"), TARGET_SMILES)
    cfg = parse_train_args([
        "--raw_file", str(tmp_path / "chembl.smi"),
        "--drug_raw_file", str(tmp_path / "drugs.smi"), "--max_atom", "25",
        "--dim", str(D), "--heads", str(HEADS), "--batch_size", "2",
        "--epoch", "1", "--compute_dtype", "bf16", "--fused_mlp",
        "--fused_critic", "--use_pallas", "--device", "cpu",
        "--mol_data_dir", str(tmp_path / "c"), "--drug_data_dir", str(tmp_path / "cd"),
        "--log_dir", str(tmp_path / "l"), "--sample_dir", str(tmp_path / "s"),
        "--model_save_dir", str(tmp_path / "m"), "--set_seed", "--seed", "7"])
    tr = Trainer(cfg)
    assert all(m.use_pallas for m in tr.G.modules() if isinstance(m, GraphMHA))
    assert not any(m.use_pallas for m in tr.D.modules() if isinstance(m, GraphMHA))
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = port.edge_attention_fwd, port.edge_attention_bwd
    monkeypatch.setattr(port, "edge_attention_fwd",
                        lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a))
    monkeypatch.setattr(port, "edge_attention_bwd",
                        lambda *a: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a))
    n = tr.vertexes
    x = np.zeros((2, n), np.int8)
    a = np.zeros((2, n, n), np.int8)
    for tier in (0, 1, 2, 3):
        step = tr.step_fn
        assert step.g_numerics["use_pallas"] == (tier < 2)
        assert step.d_first["use_pallas"] is step.d_gp["use_pallas"] is False
        calls.update(fwd=0, bwd=0)
        out = step(x, a, x, a)
        assert np.isfinite(out["d_loss"].float().item())
        # one G forward kept for the G update (share_fake), one backward
        assert calls == ({"fwd": 1, "bwd": 1} if tier < 2 else {"fwd": 0, "bwd": 0})
        if tier < 3:
            tr._escalate_numerics()
