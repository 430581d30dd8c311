"""K7/K8, the megablock, and ``--fused_block`` in the PyTorch port.

The port's plain versions of the forward and backward kernels (what its
wrappers run for a CPU tensor) are held against the JAX package's Pallas
kernels (``_run_fwd``, ``_run_bwd``) run through the interpreter on the same
numpy inputs, at B 2, N 7 (JAX pads the vertices to 16 and masks the padded
keys), D 32, H 64, 4 heads; one interpreted forward and backward per dtype
serves every comparison (a module-scoped fixture).  Tolerances: f32 atol and
rtol 2e-5 on the outputs and 2e-4 on the gradients (the same f32 math summed
in another order); bf16 outputs within 2 bf16 ulps of the Pallas ones (an f32
sum in another order can move a rounding to the neighbouring value, once for
``u`` before fc1 and once at the end), bf16 gradients as K6's
(``test_torch_port_fused_attention.py``): dq, dk, dv, dy atol 1e-2 + rtol
2^-7, the f32 parameter gradients relative norm 1e-5, with every row of
``dy`` beyond tolerance witnessed at the ReLU kink
(``fused_block.witness_kink_flips``).  The routing rule is compared with
the one the JAX op takes; the block-mode ``EncoderBlock`` and a depth-2
Generator against flax's block mode (f32, 1e-4), with the same parameter
names as the ordinary mode; the ``--use_pallas`` routing matrix and the
numerics ladder on the port's train step.  The ``--fused_block`` train step
against JAX is in ``test_torch_port_train_step.py`` (it shares that file's
compiled JAX step).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from druggen_tpu.data.corpus import DRUGLIKE_SMILES, TARGET_SMILES, write_corpus
from druggen_tpu.models.layers import EncoderBlock as FlaxEncoderBlock
from druggen_tpu.models.models import Generator as FlaxGenerator
from druggen_tpu.ops import fused_block as jax_fb
from druggen_tpu_torch.config import parse_train_args
from druggen_tpu_torch.interop import weights
from druggen_tpu_torch.models import Discriminator, EncoderBlock, Generator
from druggen_tpu_torch.ops import fused_attention, fused_block as port, fused_mlp
from druggen_tpu_torch.train.step import TrainStep
from druggen_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

B, N, D, H, HEADS = 2, 7, 32, 64, 4
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _inputs(seed, n=N, d=D, h=H):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    acts = [arr(B, n, d), arr(B, n, d), arr(B, n, d), arr(B, n, n, d)]
    params = [arr(d, d, scale=d ** -0.5), arr(d, scale=0.1), arr(d, d, scale=d ** -0.5),
              arr(d, scale=0.1), arr(d, scale=0.1, shift=1.0), arr(d, scale=0.1),
              arr(d, h, scale=d ** -0.5), arr(h, scale=0.1), arr(h, d, scale=h ** -0.5),
              arr(d, scale=0.1), arr(d, scale=0.1, shift=1.0), arr(d, scale=0.1)]
    cot = [arr(B, n, n, d), arr(B, n, d)]
    return acts, params, cot


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(w):
    """The spacing of bf16 values at |w| (8 significant bits), floored at
    the spacing at 2^-8."""
    mag = np.maximum(np.abs(w), 2.0 ** -8)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "bf16"])
def pallas_run(request):
    """One interpreted Pallas forward and backward on numpy inputs."""
    tdt, jdt = request.param
    acts, params, (gy, gn) = _inputs(0)
    ja = [jnp.asarray(x, jdt) for x in acts]
    jp = [jnp.asarray(x) for x in params]
    fwd = jax_fb._run_fwd(*ja, jp, HEADS, True)
    bwd = jax_fb._run_bwd(*ja, jp, jnp.asarray(gy, jdt), jnp.asarray(gn, jdt), HEADS, True)
    return tdt, acts, params, (gy, gn), [_f32(x) for x in fwd], [_f32(x) for x in bwd]


def test_plain_fwd_matches_pallas(pallas_run):
    tdt, acts, params, _, fwd, _ = pallas_run
    got = port.fused_block_fwd(*_torch(acts, tdt), *_torch(params), HEADS)
    for name, g, w in zip(("y_out", "node_agg"), got, fwd):
        assert g.dtype == tdt and g.shape == w.shape, name
        g = _f32(g)
        if tdt == torch.float32:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=name)
        else:
            assert (np.abs(g - w) <= 2 * _bf16_ulp(w)).all(), name


def _row_ok(dtype):
    if dtype == torch.bfloat16:
        return lambda a, b: ((a.float() - b.float()).abs()
                             <= 1e-2 + 2 ** -7 * b.float().abs()).all(-1)
    return lambda a, b: ((a.float() - b.float()).abs() <= 2e-4 + 2e-4 * b.float().abs()).all(-1)


def test_plain_bwd_matches_pallas(pallas_run):
    """Against ``_run_bwd``: the 16 gradients.  A ``dy`` row beyond tolerance
    must be witnessed at the ReLU kink, and the plain version then takes the
    witnessed side at those units."""
    tdt, acts, params, (gy, gn), _, bwd = pallas_run
    args = (*_torch(acts, tdt), *_torch(params))
    cots = (torch.from_numpy(gy).to(tdt), torch.from_numpy(gn).to(tdt))
    got = port.fused_block_bwd(*args, *cots, HEADS)
    want_dy = torch.from_numpy(bwd[3]).to(tdt)
    row_ok = _row_ok(tdt)
    bad = torch.nonzero(~row_ok(want_dy.reshape(-1, D), got[3].reshape(-1, D))).flatten()
    relu_set = None
    if len(bad):
        relu_set, unexplained = port.witness_kink_flips(
            *args[:4], args[4:], *cots, HEADS, want_dy, bad, row_ok)
        assert len(unexplained) == 0, unexplained
        got = port.fused_block_bwd_reference(*args, *cots, HEADS, relu_set=relu_set)
    for i, (name, g, w) in enumerate(zip(port.GRAD_NAMES, got, bwd)):
        assert g.dtype == (tdt if i < 4 else torch.float32), name
        assert g.shape == w.shape, name
        g = _f32(g)
        if tdt == torch.float32:
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=2e-4, err_msg=name)
        elif i < 4:
            np.testing.assert_allclose(g, w, atol=1e-2, rtol=2 ** -7, err_msg=name)
        else:
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_oracle_matches_jnp(tdt, jdt):
    acts, params, _ = _inputs(1)
    got = port.block_edge_stream_reference(*_torch(acts, tdt), *_torch(params), HEADS)
    want = jax_fb.jnp_block_edge_stream(*[jnp.asarray(x, jdt) for x in acts],
                                        *[jnp.asarray(x) for x in params], heads=HEADS)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        g, w = _f32(g), _f32(w)
        if tdt == torch.float32:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
        else:
            assert (np.abs(g - w) <= _bf16_ulp(w)).all()


def test_function_gradients_match_the_oracle():
    """``FusedBlock`` (the plain K7/K8 here) under autograd against
    ``torch.autograd.grad`` of the oracle, all 16 input gradients, f32."""
    acts, params, (gy, gn) = _inputs(2)
    base = _torch(acts) + _torch(params)
    cots = (torch.from_numpy(gy), torch.from_numpy(gn))
    leaves = [t.clone().requires_grad_() for t in base]
    want = torch.autograd.grad(port.block_edge_stream_reference(*leaves, HEADS), leaves, cots)
    leaves = [t.clone().requires_grad_() for t in base]
    got = torch.autograd.grad(port.FusedBlock.apply(*leaves, HEADS), leaves, cots)
    for name, g, w in zip(port.GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


def test_second_derivative_raises():
    acts, params, _ = _inputs(3)
    leaves = [t.requires_grad_() for t in _torch(acts) + _torch(params)]
    y_out, _ = port.FusedBlock.apply(*leaves, HEADS)
    (gq,) = torch.autograd.grad(y_out.square().sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), leaves[4])


def test_routing_rule_matches_jax(monkeypatch):
    """For each width: the port's rule takes the kernels on the card exactly
    when the JAX op takes its Pallas ``custom_vjp`` on the TPU
    (``interpret=False``), and on the CPU exactly when JAX's interpret mode
    does (every width)."""
    taken = []
    monkeypatch.setattr(jax_fb, "_fused_block_op",
                        lambda q, k, v, y, *rest: taken.append(True) or (y, q))
    for d in (32, 64, 96, 128, 160, 256, 384, 512):
        spec = jax.ShapeDtypeStruct
        f32 = jnp.float32
        shapes = [spec((1, 5, d), f32)] * 3 + [spec((1, 5, 5, d), f32)]
        pshapes = [spec(s, f32) for s in ((d, d), (d,), (d, d), (d,), (d,), (d,),
                                          (d, 2 * d), (2 * d,), (2 * d, d), (d,), (d,), (d,))]
        for interpret, device in ((False, "cuda"), (True, "cpu")):
            taken.clear()
            jax.eval_shape(lambda *a: jax_fb.fused_block_edge_stream(
                *a, heads=4, interpret=interpret), *shapes, *pshapes)
            assert port.uses_kernel(d, device) == bool(taken), (d, device)
    assert [port.uses_kernel(d, "cuda") for d in (64, 128, 256)] == [False, True, True]


# --- modules against flax's block mode ----------------------------------------

def _flat_grads(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_encoder_block_in_block_mode_matches_flax():
    """Outputs and the input and parameter gradients of a loss of both
    outputs: the port's block-mode EncoderBlock (plain K7/K8 under autograd)
    against flax's (Pallas in the interpreter), from one flax init; the
    parameter names are those of the ordinary mode, so the same converted
    weights load into both."""
    rng = np.random.default_rng(4)
    node = rng.normal(size=(B, N, D)).astype(np.float32)
    edge = rng.normal(size=(B, N, N, D)).astype(np.float32)
    wn = rng.normal(size=(B, N, D)).astype(np.float32)
    we = rng.normal(size=(B, N, N, D)).astype(np.float32)
    flax_blk = FlaxEncoderBlock(D, HEADS, 2, fused_mlp="block")
    variables = flax_blk.init(jax.random.PRNGKey(5), node, edge)
    plain_vars = FlaxEncoderBlock(D, HEADS, 2).init(jax.random.PRNGKey(5), node, edge)
    assert _flat_grads(variables).keys() == _flat_grads(plain_vars).keys()

    @jax.jit
    def out_and_grads(params, x, y):
        out, vjp = jax.vjp(flax_blk.apply, params, x, y)
        return out, vjp((jnp.asarray(wn), jnp.asarray(we)))

    want_out, (want_g, want_x, want_y) = out_and_grads(variables, node, edge)
    sd = weights.flax_encoder_block_to_torch(variables)
    blk = EncoderBlock(D, HEADS, 2, fused_mlp="block")
    assert blk.state_dict().keys() == EncoderBlock(D, HEADS, 2).state_dict().keys()
    blk.load_state_dict(weights.to_torch_tensors(sd))
    blk.eval()
    calls = []
    apply = port.FusedBlock.apply
    port.FusedBlock.apply = lambda *a: calls.append(1) or apply(*a)
    try:
        x, y = (torch.from_numpy(a).requires_grad_() for a in (node, edge))
        no, eo = blk(x, y)
    finally:
        port.FusedBlock.apply = apply
    assert calls == [1]
    for g, w in zip((no, eo), want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    ((no * torch.from_numpy(wn)).sum() + (eo * torch.from_numpy(we)).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want_y), atol=1e-4, rtol=1e-4)
    grads_sd = weights.flax_encoder_block_to_torch(jax.tree_util.tree_map(np.asarray, want_g))
    for name, p in blk.named_parameters():
        w = grads_sd[name]
        rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (name, rel)


def test_generator_in_block_mode_matches_flax():
    """A depth-2 Generator, ``fused_mlp="block"``, against flax's, f32: the
    same converted weights as the ordinary mode's (the checkpoint format
    does not change)."""
    n_atoms, b_dim, m_dim = 9, 5, 8
    rng = np.random.default_rng(6)
    z_e = rng.normal(size=(B, n_atoms, n_atoms, b_dim)).astype(np.float32)
    z_n = rng.normal(size=(B, n_atoms, m_dim)).astype(np.float32)
    kw = dict(act="relu", vertexes=n_atoms, edges=b_dim, nodes=m_dim, dropout=0.0,
              dim=D, depth=2, heads=HEADS, mlp_ratio=2)
    variables = FlaxGenerator(**kw).init(jax.random.PRNGKey(3), z_e, z_n)
    want = jax.jit(FlaxGenerator(**kw, fused_mlp="block").apply)(variables, z_e, z_n)
    gen = Generator(**kw, fused_mlp="block")
    gen.load_state_dict(weights.to_torch_tensors(weights.flax_generator_to_torch(variables)))
    gen.eval()
    calls = []
    fwd = port.fused_block_fwd
    port.fused_block_fwd = lambda *a: calls.append(1) or fwd(*a)
    try:
        with torch.no_grad():
            got = gen(torch.from_numpy(z_e), torch.from_numpy(z_n))
    finally:
        port.fused_block_fwd = fwd
    assert len(calls) == 2
    for name, g, w in zip(("node", "edge", "node_logits", "edge_logits"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


# --- the train step's routing --------------------------------------------------

def _count(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(module, name, counted)
    return calls


def test_use_pallas_with_fused_block_routes_as_jax(monkeypatch):
    """``--fused_block --use_pallas`` (JAX ``layers.py:274-277``): the
    Generator's blocks take K5/K6 and the fused tail K1/K2 (``"block"`` is
    truthy there), the critic's first-order passes the megablock K7/K8, the
    gradient-penalty pass neither.  dim 128 (K5's rule), one bf16 step of
    depth 1: K7 runs once for G and three times for the critic (real, fake,
    the G step's pass), K8 once for each of the three critic passes that
    are differentiated."""
    n, m_dim, b_dim, batch = 5, 5, 4, 2
    kw = dict(act="relu", vertexes=n, edges=b_dim, nodes=m_dim, dropout=0.0, dim=128,
              depth=1, heads=8, mlp_ratio=2, dtype=torch.bfloat16)
    G = Generator(fused_mlp="block", use_pallas=True, **kw)
    D = Discriminator(**kw)
    from druggen_tpu_torch.train.optim import AdamW
    step = TrainStep(G, D, AdamW(G, 1e-4), AdamW(D, 1e-4), lambda_gp=10.0, m_dim=m_dim,
                     b_dim=b_dim, compute_dtype=torch.bfloat16, g_fused="block",
                     fused_critic="block", g_pallas=True)
    k57 = _count(monkeypatch, port, ("fused_block_fwd", "fused_block_bwd"))
    k56 = _count(monkeypatch, fused_attention, ("edge_attention_fwd", "edge_attention_bwd"))
    k12 = _count(monkeypatch, fused_mlp, ("fused_ln_mlp_ln", "fused_ln_mlp_ln_bwd"))
    rng = np.random.default_rng(0)
    x, a = rng.integers(0, m_dim, (batch, n)), rng.integers(0, b_dim, (batch, n, n))
    out = step(x, a, x, a)
    assert math.isfinite(out["d_loss"].item()) and math.isfinite(out["g_loss"].item())
    assert k56 == {"edge_attention_fwd": 1, "edge_attention_bwd": 1}
    assert k12 == {"fused_ln_mlp_ln": 1, "fused_ln_mlp_ln_bwd": 1}
    assert k57 == {"fused_block_fwd": 3, "fused_block_bwd": 3}


def test_ladder_turns_the_megablock_off_at_tiers_2_and_3(tmp_path, monkeypatch):
    """``--fused_block`` trains (it no longer raises): at tiers 0 and 1 the
    Generator and the critic's first-order passes run the megablock (its
    plain versions here, at every width) — 4 K7 and 4 K8 a step at depth 1
    — and at tier 2 (f32 softmax) and tier 3 (full f32) nothing does, on
    the same parameters."""
    write_corpus(str(tmp_path / "chembl.smi"), DRUGLIKE_SMILES)
    write_corpus(str(tmp_path / "drugs.smi"), TARGET_SMILES)
    cfg = parse_train_args([
        "--raw_file", str(tmp_path / "chembl.smi"),
        "--drug_raw_file", str(tmp_path / "drugs.smi"), "--max_atom", "25",
        "--dim", "16", "--heads", "2", "--batch_size", "2", "--epoch", "1",
        "--compute_dtype", "bf16", "--fused_block", "--device", "cpu",
        "--mol_data_dir", str(tmp_path / "c"), "--drug_data_dir", str(tmp_path / "cd"),
        "--log_dir", str(tmp_path / "l"), "--sample_dir", str(tmp_path / "s"),
        "--model_save_dir", str(tmp_path / "m"), "--set_seed", "--seed", "7"])
    tr = Trainer(cfg)
    calls = _count(monkeypatch, port, ("fused_block_fwd", "fused_block_bwd"))
    n = tr.vertexes
    x = np.zeros((2, n), np.int8)
    a = np.zeros((2, n, n), np.int8)
    for tier in (0, 1, 2, 3):
        step = tr.step_fn
        on = tier < 2
        assert step.g_numerics["fused_mlp"] == ("block" if on else False)
        assert step.d_first["fused_mlp"] == ("block" if on else False)
        assert step.d_gp["fused_mlp"] is False
        calls.update(fused_block_fwd=0, fused_block_bwd=0)
        out = step(x, a, x, a)
        assert np.isfinite(out["d_loss"].float().item())
        assert calls == ({"fused_block_fwd": 4, "fused_block_bwd": 4} if on
                         else {"fused_block_fwd": 0, "fused_block_bwd": 0})
        if tier < 3:
            tr._escalate_numerics()
