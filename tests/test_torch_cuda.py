"""The port's CUDA kernels and serving path on the card, against their plain
PyTorch versions and the CPU.

Marked ``cuda``: each test asks the ``card`` fixture for the device, and the
fixture skips where there is none, so the CPU run collects the same tests
as a card run and skips them here. On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the machine with
the card need not have; this file imports none of it.)

Tolerances are relative to max|plain|, TF32 off on both sides: 1e-4 for one
product or one NS step (3xTF32 tensor-core sums in another order than
cuBLAS's SGEMM), 1e-3 for NS chains, tiled or fused, whose cubic polynomial
compounds the rounding of each step, and 1e-5 for the NorMuon row
normalization, where only the order of the row sum of squares differs.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.newton_schulz import PAPER_COEFFS, orthogonalize, orthogonalize_plain
from repro_torch.kernels import normuon
from repro_torch.kernels.newton_schulz import fused, ops
from repro_torch.kernels.newton_schulz import newton_schulz as tiled

pytestmark = pytest.mark.cuda

PRODUCT_TOL, CHAIN_TOL, NORM_TOL = 1e-4, 1e-3, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _rand(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _assert_rel(out, ref, tol):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.is_cuda
    err = float((out.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("b,m,k,n", [(1, 128, 128, 128), (3, 100, 300, 50), (2, 1, 9, 1),
                                     (2, 257, 130, 129)])
def test_matmul_and_fma_matmul_match_plain(card, b, m, k, n):
    x, y, c = _rand((b, m, k), 1, card), _rand((b, k, n), 2, card), _rand((b, m, n), 3, card)
    _assert_rel(tiled.matmul(x, y), tiled.matmul_plain(x, y), PRODUCT_TOL)
    _assert_rel(tiled.fma_matmul(x, y, c, alpha=2.0, beta=-1.5),
                tiled.fma_matmul_plain(x, y, c, alpha=2.0, beta=-1.5), PRODUCT_TOL)
    _assert_rel(tiled.matmul(x[0], y[0]), tiled.matmul_plain(x[0], y[0]), PRODUCT_TOL)
    assert (tiled.matmul.launches, tiled.fma_matmul.launches) == (2, 1)


def test_gram_reads_the_transposed_operand_in_place(card):
    x = _rand((3, 70, 200), 4, card)
    _assert_rel(tiled.matmul(x, x.transpose(-1, -2)),
                tiled.matmul_plain(x, x.transpose(-1, -2)), PRODUCT_TOL)
    strided = _rand((3, 200, 140), 5, card)[:, :, ::2]  # neither layout: packed first
    _assert_rel(tiled.matmul(x, strided), tiled.matmul_plain(x, strided), PRODUCT_TOL)


def test_symmetric_gram_and_polynomial_match_plain_and_are_symmetric(card):
    """Several tiles a side: the upper tiles, their mirrors and the diagonal."""
    x = _rand((2, 384, 512), 20, card)
    gram = tiled.matmul(x, x.transpose(-1, -2), symmetric=True)
    _assert_rel(gram, tiled.matmul_plain(x, x.transpose(-1, -2)), PRODUCT_TOL)
    assert torch.equal(gram, gram.mT)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=-1.5, beta=0.5, symmetric=True)
    _assert_rel(poly, tiled.fma_matmul_plain(gram, gram, gram, alpha=-1.5, beta=0.5), PRODUCT_TOL)
    assert torch.equal(poly, poly.mT)
    assert (tiled.matmul.launches, tiled.fma_matmul.launches) == (1, 1)
    assert kernels.packed_launches() == 0


@pytest.mark.parametrize("symmetric", [True, False])
def test_product_at_the_mlp_gram_depth_keeps_fp32_accuracy(card, symmetric):
    """K = 6144, the full-phase MLP Gram's depth: the 3xTF32 sums over 192
    K slices, promoted to an fp32 register sum every four."""
    x = _rand((2, 256, 6144), 21, card)
    y = x.transpose(-1, -2) if symmetric else _rand((2, 6144, 256), 22, card)
    _assert_rel(tiled.matmul(x, y, symmetric=symmetric), tiled.matmul_plain(x, y), PRODUCT_TOL)


def test_unaligned_operands_are_packed_and_still_match(card):
    x, y, c = _rand((2, 33, 30), 23, card), _rand((2, 30, 18), 24, card), _rand((2, 33, 18), 25, card)
    _assert_rel(tiled.fma_matmul(x, y, c, alpha=0.5, beta=2.0),
                tiled.fma_matmul_plain(x, y, c, alpha=0.5, beta=2.0), PRODUCT_TOL)
    assert (tiled.fma_matmul.launches, tiled.fma_matmul.packed_launches) == (1, 1)
    offset = torch.empty(2 * 64 * 128 + 1, device=card)[1:].view(2, 64, 128)  # off the 16-byte grid
    offset.copy_(_rand((2, 64, 128), 26, card))
    _assert_rel(tiled.matmul(offset, y[:, :1].expand(2, 128, 18).contiguous()),
                tiled.matmul_plain(offset, y[:, :1].expand(2, 128, 18).contiguous()), PRODUCT_TOL)
    assert (tiled.matmul.launches, tiled.matmul.packed_launches) == (1, 1)
    aligned = _rand((2, 64, 128), 27, card)
    tiled.matmul(aligned, aligned.transpose(-1, -2), symmetric=True)
    assert kernels.packed_launches() == 2


@pytest.mark.parametrize("shape", [(4, 13, 150), (2, 130, 200), (1, 48, 1536)])
def test_fused_chain_and_iteration_match_plain(card, shape):
    x = _rand(shape, 6, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    ref = fused.ns_chain_plain(x, PAPER_COEFFS, 5)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), ref, CHAIN_TOL)
    y = x
    for _ in range(5):
        y = fused.ns_iteration(y, PAPER_COEFFS)
    _assert_rel(y, ref, CHAIN_TOL)
    assert (fused.ns_chain.launches, fused.ns_iteration.launches) == (1, 5)


# (B, m, n), K: the chain's small sides on the training paths (12: the norm
# gains, 48: the k/v blocks, 64: Dion's polar factors, 192: the attention
# blocks, 768: the MLP blocks), ragged sides, and the depths K = 1, 3, 5, 6.
CHAIN_CASES = [
    ((2, 12, 1536), 5), ((6, 48, 1536), 3), ((4, 64, 1536), 6), ((3, 64, 6144), 6),
    ((4, 192, 1536), 5), ((3, 768, 1536), 5), ((2, 768, 1536), 1), ((4, 13, 150), 3),
    ((2, 130, 200), 6), ((2, 200, 260), 1),
]


@pytest.mark.parametrize("shape,steps", CHAIN_CASES)
def test_fused_chain_matches_plain_at_every_side_and_depth(card, shape, steps):
    x = _rand(shape, 40, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    out = fused.ns_chain(x, PAPER_COEFFS, steps)
    _assert_rel(out, fused.ns_chain_plain(x, PAPER_COEFFS, steps), CHAIN_TOL)
    assert (fused.ns_chain.launches, fused.ns_chain.packed_launches) == (1, int(shape[-1] % 4 != 0))


@pytest.mark.parametrize("units,m,n", [(2, 192, 1536), (1024, 48, 1536), (1000, 12, 64)])
def test_fused_chain_over_small_and_large_buckets(card, units, m, n):
    """2 units (clusters of 8, most SMs idle) and >= 1000 units (many waves)."""
    x = _rand((units, m, n), 41, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), fused.ns_chain_plain(x, PAPER_COEFFS, 5),
                CHAIN_TOL)


def test_fused_chain_packs_an_unaligned_stack_and_still_matches(card):
    x = _rand((3, 40, 150), 42, card)  # rows of 600 bytes: off the 16-byte grid
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    out = fused.ns_chain(x, PAPER_COEFFS, 5)
    _assert_rel(out, fused.ns_chain_plain(x, PAPER_COEFFS, 5), CHAIN_TOL)
    offset = torch.empty(2 * 48 * 256 + 1, device=card)[1:].view(2, 48, 256)  # base off the grid
    offset.copy_(_rand((2, 48, 256), 43, card) / 40.0)
    _assert_rel(fused.ns_iteration(offset, PAPER_COEFFS),
                fused.ns_chain_plain(offset, PAPER_COEFFS, 1), CHAIN_TOL)
    assert (fused.ns_chain.packed_launches, fused.ns_iteration.packed_launches) == (1, 1)
    assert kernels.packed_launches() == 2


@pytest.mark.parametrize("shape", [(16, 768, 1536), (24, 384, 1536), (2, 12, 1536), (192, 48, 1536)])
def test_fused_chain_is_deterministic(card, shape):
    """A race between a stage's writes and the next stage's reads (the
    cluster barrier, the proxy fences) would show as two runs that differ."""
    x = _rand(shape, 44, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    first = fused.ns_chain(x, PAPER_COEFFS, 5)
    second = fused.ns_chain(x, PAPER_COEFFS, 5)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape", [(4, 192, 1536), (3, 13, 150)])
def test_fused_chain_of_one_step_is_the_fused_iteration(card, shape):
    x = _rand(shape, 45, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    one = fused.ns_chain(x, PAPER_COEFFS, 1)
    torch.cuda.synchronize()
    assert torch.equal(one, fused.ns_iteration(x, PAPER_COEFFS))
    _assert_rel(one, ops.ns_iteration(x, PAPER_COEFFS), PRODUCT_TOL)


@pytest.mark.parametrize("strategy", ["fused_chain", "fused_iter", "tiled", None])
@pytest.mark.parametrize("shape", [(2, 40, 24), (3, 2, 24, 40), (130, 66)])
def test_dispatch_strategies_match_plain_orthogonalize(card, strategy, shape):
    g = _rand(shape, 7, card)
    _assert_rel(orthogonalize(g, steps=5, strategy=strategy), orthogonalize_plain(g, steps=5),
                CHAIN_TOL)
    assert sum(kernels.launch_counts().values()) > 0


def test_tiled_chain_launches_three_products_per_step(card):
    g = _rand((4, 64, 96), 8, card)
    _assert_rel(ops.orthogonalize(g, steps=5), orthogonalize_plain(g, steps=5), CHAIN_TOL)
    assert (tiled.matmul.launches, tiled.fma_matmul.launches) == (5, 10)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(TypeError):
        tiled.matmul(_rand((4, 8), 9, card).double(), _rand((8, 4), 10, card).double())
    with pytest.raises(ValueError):
        fused.ns_chain(_rand((2, 16, 8), 11, card), PAPER_COEFFS, 1)  # m > n
    with pytest.raises(ValueError):
        tiled.matmul(_rand((4, 8), 12, card), _rand((8, 4), 13, card).cpu())
    assert sum(kernels.launch_counts().values()) == 0


def test_reduced_training_on_the_card_tracks_the_cpu(card):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    base = init_params(get_config("muonbp-960m").reduced(), seed=0, device="cpu")
    argv = ["--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32"]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    gpu = train.run(argv + ["--device", "cuda"],
                    params=tree_lib.tree_map(lambda p: p.to("cuda"), base)).records
    assert kernels.launch_counts()["ns_fused_chain"] > 0
    # fp32 on both; cuBLAS and the CPU's BLAS sum in other orders, which six
    # NS-amplified updates carry into the loss (see chip_smoke.py).
    assert max(abs(g["loss"] - c["loss"]) for g, c in zip(gpu, cpu)) <= 1e-3


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("shape,offset", [((3, 10, 130), 0), ((2, 7, 17), 0), ((2, 6, 64), 1),
                                          ((12, 6144, 1536), 0)])
def test_neuron_norm_matches_plain(card, refresh, shape, offset):
    """Ragged rows, a row start off the 16-byte grid (scalar path) and the
    largest main-path leaf (mlp/wo, 73,728 rows)."""
    x = _rand(shape, 14, card)
    if offset:  # contiguous, but offset by one float from its allocation
        x = torch.empty(x.numel() + offset, device=card)[offset:].view(shape).copy_(x)
    v = _rand((*shape[:-1], 1), 15, card).abs()
    corr = normuon.bias_correction(3, 0.95)
    y, v_new = normuon.neuron_norm(x, v, corr, beta2=0.95, eps=1e-8, refresh=refresh)
    y_ref, v_ref = normuon.neuron_norm_plain(x, v, corr, beta2=0.95, eps=1e-8, refresh=refresh)
    _assert_rel(y, y_ref, NORM_TOL)
    _assert_rel(v_new, v_ref, NORM_TOL)
    assert refresh or v_new is v
    assert normuon.neuron_norm.launches == 1


def test_neuron_norm_refuses_what_the_kernel_does_not_take(card):
    x, v = _rand((2, 8, 32), 16, card), _rand((2, 8, 1), 17, card).abs()
    kw = dict(beta2=0.95, eps=1e-8, refresh=True)
    with pytest.raises(TypeError):
        normuon.neuron_norm(x.double(), v.double(), 0.5, **kw)
    with pytest.raises(TypeError):
        normuon.neuron_norm(x.to(torch.bfloat16), v, 0.5, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        normuon.neuron_norm(_rand((2, 32, 8), 18, card).transpose(-1, -2), v, 0.5, **kw)
    with pytest.raises(ValueError):
        normuon.neuron_norm(x, v.cpu(), 0.5, **kw)
    with pytest.raises(ValueError):
        normuon.neuron_norm(x, v[:, :4], 0.5, **kw)
    assert normuon.neuron_norm.launches == 0


@pytest.mark.parametrize("variant", ["normuon", "turbo_muon", "dion"])
def test_reduced_variant_training_on_the_card_tracks_the_cpu(card, variant):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    base = init_params(get_config("muonbp-960m").reduced(), seed=0, device="cpu")
    argv = ["--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32",
            "--optimizer-variant", variant]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    gpu = train.run(argv + ["--device", "cuda"],
                    params=tree_lib.tree_map(lambda p: p.to("cuda"), base)).records
    counts = kernels.launch_counts()
    assert counts["ns_fused_chain"] > 0
    assert (counts["normuon"] > 0) == (variant == "normuon")
    assert max(abs(g["loss"] - c["loss"]) for g, c in zip(gpu, cpu)) <= 1e-3


def _reduced_state_on_the_card(card, variant=None):
    """The reduced muonbp-960m on the card, its 4-way grid, one full step
    taken: (cfg, optimizer, state, batch)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import adamw, combine, label_tree, muon
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_step import init_train_state, train_step

    cfg = get_config("muonbp-960m").reduced()
    params = init_params(cfg, seed=0, device=card)
    sizes = {"model": 4}
    labels = label_tree(params)
    bspecs = tree_lib.tree_map(lambda b, l: b if l == "muon" else None,
                               sh.block_specs_for(params, sh.param_specs(params, cfg, sizes), sizes),
                               labels)
    opt = combine({"muon": muon(0.02, 0.02, period=5, block_specs=bspecs, variant=variant),
                   "adamw": adamw(0.008)}, labels)
    batches = iter(SyntheticLM(cfg, 2, 32, seed=0))
    batch = lambda: {k: torch.from_numpy(v).to(card, torch.long) for k, v in next(batches).items()}
    state, _ = train_step(init_train_state(params, opt, guard=True), batch(), cfg=cfg,
                          optimizer=opt, phase="full")
    return cfg, opt, state, batch()


def _states_equal(a, b):
    """(params, optimizer state) pairs equal leaf for leaf, as their snapshot
    arrays: every tensor and every host counter."""
    from repro_torch.training import checkpoint

    for x, y in zip(a, b):
        fx, fy = checkpoint._flatten(x), checkpoint._flatten(y)
        if fx.keys() != fy.keys() or not all(
                fx[k].dtype == fy[k].dtype and (fx[k] == fy[k]).all() for k in fx):
            return False
    return True


@pytest.mark.parametrize("variant", [None, "normuon"])
def test_guarded_update_equals_the_unguarded_update_on_the_card(card, variant):
    """On the same gradients the guarded update is torch.equal to the
    unguarded one in both phases, and a NaN gradient leaves the state as it
    was and launches no kernel."""
    from repro_torch import tree as tree_lib
    from repro_torch.core.combine import apply_updates
    from repro_torch.training import resilience
    from repro_torch.training.train_step import loss_and_grads

    cfg, opt, state, batch = _reduced_state_on_the_card(card, variant)
    loss, _, grads = loss_and_grads(state.params, batch, cfg)
    gsq = sum(torch.sum(g.float() ** 2) for g in tree_lib.leaves(grads))
    gcfg = resilience.GuardConfig()
    with torch.no_grad():
        for phase in ("block", "full"):
            upd, o_u = opt.update(grads, state.opt_state, state.params, phase)
            p_u = apply_updates(state.params, upd)
            p_g, o_g, _, healthy = resilience.guarded_update(
                opt, gcfg, grads, state.opt_state, state.params, state.guard, loss, gsq, phase)
            assert bool(healthy)
            assert _states_equal((p_u, o_u), (p_g, o_g))
        kernels.reset_launch_counts()
        nan = tree_lib.tree_map(lambda g: torch.full_like(g, float("nan")), grads)
        p_s, o_s, g_s, healthy = resilience.guarded_update(
            opt, gcfg, nan, state.opt_state, state.params, state.guard, loss,
            torch.tensor(float("nan"), device=card), "full")
    assert not bool(healthy) and int(g_s.skipped) == 1
    assert p_s is state.params and o_s is state.opt_state
    assert sum(kernels.launch_counts().values()) == 0


def test_snapshot_round_trip_card_to_cpu_and_back(card, tmp_path):
    from repro_torch import tree as tree_lib
    from repro_torch.training import checkpoint

    _, opt, state, _ = _reduced_state_on_the_card(card, "normuon")
    checkpoint.save_snapshot(str(tmp_path), state.params, state.opt_state, step=1)
    path, meta = checkpoint.latest_valid(str(tmp_path))
    cpu_p, cpu_o, step = checkpoint.restore(path, state.params, state.opt_state, device="cpu")
    assert step == 1 and not any(t.is_cuda for t in tree_lib.leaves(cpu_p))
    assert not any(t.is_cuda for t in cpu_o.inner["muon"].second_moment.values())
    assert _states_equal((cpu_p, cpu_o), (state.params, state.opt_state))
    back_p, back_o, _ = checkpoint.restore(path, cpu_p, cpu_o, device=card)
    for a, b in zip(tree_lib.leaves(back_p), tree_lib.leaves(state.params)):
        assert a.is_cuda and torch.equal(a, b)
    for path_, v in state.opt_state.inner["adamw"].mu.items():
        assert torch.equal(back_o.inner["adamw"].mu[path_], v)
    assert _states_equal((back_p, back_o), (state.params, state.opt_state))


# ---------------------------------------------------------------------------
# The serving path on the card (no kernel of its own: plain PyTorch, held to
# the CPU). Logits to 1e-4 absolute on values of O(1), fp32 with TF32 off;
# greedy tokens and the engine's event stream exactly.
# ---------------------------------------------------------------------------

def _serve_model(device, window=None):
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config("gemma2-9b").reduced()
    if window is not None:
        cfg = dataclasses.replace(cfg, window_size=window)
    params = init_params(cfg, seed=0, device="cpu")
    return cfg, tree_lib.tree_map(lambda p: p.to(device), params)


def test_prefill_and_decode_on_the_card_track_the_cpu(card):
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.serve_step import cache_from_prefill

    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 512, (2, 16), generator=gen)
    pos = torch.tensor([9, 15])
    outs = {}
    for device in ("cpu", card):
        cfg, params = _serve_model(device, window=4)
        with torch.no_grad():
            logits_p, pcache = prefill(params, {"tokens": tokens[:, :8].to(device)}, cfg)
            cache = cache_from_prefill(pcache, cfg, 16, dtype=torch.float32)
            steps = []
            for t in range(8, 16):
                lg, cache = decode_step(params, tokens[:, t:t + 1].to(device), cache, t, cfg)
                steps.append(lg)
            # one more step with the rows at their own positions
            rows, _ = decode_step(params, tokens[torch.arange(2), pos][:, None].to(device), cache,
                                  pos.to(device), cfg)
        outs[str(device)] = [logits_p, cache["kv"][0], *steps, rows]
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert b.is_cuda
        assert float((b.cpu() - a).abs().max()) <= 1e-4


def _run_engine(device, plan=None):
    from repro_torch.obs.bus import Bus, MemorySink
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.training.faults import FaultPlan, set_active

    cfg, params = _serve_model(device)
    bus = Bus([MemorySink()])
    eng = ServingEngine(params, cfg, EngineConfig(slots=3, block_size=16, max_model_len=128,
                                                  num_blocks=24, max_prompt_len=112,
                                                  max_new_tokens=16),
                        bus=bus, fault_plan=FaultPlan.parse(plan) if plan else None)
    gen = torch.Generator().manual_seed(1)
    for i, n in enumerate((100, 70, 20, 5)):
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
        assert eng.submit(Request(rid=f"r{i}", prompt=prompt, max_new_tokens=16 - 4 * i), 0.0)
    t = 0.0
    while not eng.idle:
        eng.step(t)
        t += 1.0
    set_active(None)
    events = [{k: v for k, v in r.items() if k not in ("ts", "dur_s")}
              for r in bus.sinks[0].records]
    return eng, [(r.rid, r.state, r.reason, r.tokens) for r in eng.finished], events


@pytest.mark.parametrize("plan", [None, "corrupt_cache@2"])
def test_engine_on_the_card_gives_the_cpu_tokens_and_events(card, plan):
    eng, finished, events = _run_engine(card, plan)
    assert eng.kv.k.is_cuda and eng.outstanding_blocks() == 0
    _, cpu_finished, cpu_events = _run_engine("cpu", plan)
    assert finished == cpu_finished
    assert events == cpu_events


def test_paged_pool_is_written_in_place_on_the_card(card):
    """A decode step allocates nothing of the pool's size: the pools keep
    their storage, and the step's peak allocation above what was live
    stays a fraction of the pool (the per-layer windows and activations)."""
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg, params = _serve_model(card)
    eng = ServingEngine(params, cfg, EngineConfig(slots=2, block_size=4, max_model_len=32,
                                                  num_blocks=4096, max_prompt_len=16,
                                                  max_new_tokens=8))
    pool_bytes = 2 * eng.kv.k.numel() * eng.kv.k.element_size()
    ptrs = (eng.kv.k.data_ptr(), eng.kv.v.data_ptr())
    for i in range(2):
        assert eng.submit(Request(rid=f"r{i}", prompt=torch.arange(10 + i).numpy(),
                                  max_new_tokens=8), 0.0)
    eng.step(0.0)  # admission (prefill) and a first decode
    for t in range(1, 4):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.step(float(t))
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before < pool_bytes / 8
        assert (eng.kv.k.data_ptr(), eng.kv.v.data_ptr()) == ptrs


# ---------------------------------------------------------------------------
# Mixture-of-Experts: the new bucket shapes, the reduced models, determinism
# ---------------------------------------------------------------------------

MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]


def test_kernels_at_the_router_shape_match_plain(card):
    """olmoe's 64 x 2048 router units, fewer rows than the kernels' 128-row
    tile: the fused chain, the three tiled products and the tiled chain."""
    a, b, c = PAPER_COEFFS
    x = _rand((4, 64, 2048), 50, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), fused.ns_chain_plain(x, PAPER_COEFFS, 5),
                CHAIN_TOL)
    xt = x.transpose(-1, -2)
    gram = tiled.matmul(x, xt, symmetric=True)
    _assert_rel(gram, tiled.matmul_plain(x, xt), PRODUCT_TOL)
    assert torch.equal(gram, gram.mT)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True)
    _assert_rel(poly, tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c), PRODUCT_TOL)
    _assert_rel(tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
                tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), PRODUCT_TOL)
    _assert_rel(ops.orthogonalize(x, steps=5, normalize=False),
                fused.ns_chain_plain(x, PAPER_COEFFS, 5), CHAIN_TOL)
    assert fused.ns_chain.launches == 1 and tiled.matmul.launches == 1 + 5
    assert kernels.packed_launches() == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_training_on_the_card_tracks_the_cpu(card, arch):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    base = init_params(get_config(arch).reduced(), seed=0, device="cpu")
    argv = ["--arch", arch, "--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32"]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    gpu = train.run(argv + ["--device", "cuda"],
                    params=tree_lib.tree_map(lambda p: p.to("cuda"), base)).records
    assert kernels.launch_counts()["ns_fused_chain"] > 0
    # fp32, 1e-3 of each value as the dense run's loss above: the aux losses
    # sum squared router log-sum-exps of ~4 (z_loss) and load shares over
    # the layers, so the card's summation order shows relative to them.
    for key in ("loss", "load_balance", "z_loss"):
        assert max(abs(g[key] - c[key]) / max(1.0, abs(c[key]))
                   for g, c in zip(gpu, cpu)) <= 1e-3, key


def _moe_model(arch, device, **over):
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = init_params(cfg, seed=0, device="cpu")
    return cfg, tree_lib.tree_map(lambda p: p.to(device), params)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_serving_on_the_card_tracks_the_cpu(card, arch):
    """Prefill and batched decode (drops at the default capacity) to 1e-4,
    the ring cache for the sliding-window arch, and the engine's tokens and
    events, card against CPU."""
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.obs.bus import Bus, MemorySink
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.serving.serve_step import cache_from_prefill

    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 512, (2, 16), generator=gen)
    outs, engines = {}, {}
    for device in ("cpu", card):
        cfg, params = _moe_model(arch, device)
        with torch.no_grad():
            logits_p, pcache = prefill(params, {"tokens": tokens[:, :8].to(device)}, cfg)
            cache = cache_from_prefill(pcache, cfg, 16, dtype=torch.float32)
            steps = [logits_p]
            for t in range(8, 16):
                steps.append(decode_step(params, tokens[:, t:t + 1].to(device), cache, t, cfg)[0])
            if cfg.attention_pattern == "swa":
                ring = init_cache(cfg, 2, 6, dtype=torch.float32, device=device)
                for t in range(16):
                    steps.append(decode_step(params, tokens[:, t:t + 1].to(device), ring, t, cfg,
                                             ring_cache=True)[0])
        outs[str(device)] = steps
        bus = Bus([MemorySink()])
        eng = ServingEngine(params, cfg, EngineConfig(slots=3, block_size=16, max_model_len=128,
                                                      num_blocks=24, max_prompt_len=112,
                                                      max_new_tokens=16), bus=bus)
        for i, n in enumerate((100, 70, 20, 5)):
            assert eng.submit(Request(rid=f"r{i}", prompt=torch.arange(n).numpy() % 500,
                                      max_new_tokens=16 - 4 * i), 0.0)
        t = 0.0
        while not eng.idle:
            eng.step(t)
            t += 1.0
        engines[str(device)] = ([(r.rid, r.state, r.tokens) for r in eng.finished],
                                [{k: v for k, v in r.items() if k not in ("ts", "dur_s")}
                                 for r in bus.sinks[0].records])
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert b.is_cuda and float((b.cpu() - a).abs().max()) <= 1e-4
    assert engines[str(card)] == engines["cpu"]


def test_moe_block_is_deterministic_on_the_card(card):
    """bf16 forward and backward twice on one input: bitwise equal (no
    atomic adds in the dispatch or the combine)."""
    from repro_torch.models.moe import moe_block

    x = _rand((4, 256, 128), 60, card).to(torch.bfloat16)
    w = {"router": _rand((128, 8), 61, card), "wi": _rand((8, 128, 96), 62, card),
         "wg": _rand((8, 128, 96), 63, card), "wo": _rand((8, 96, 128), 64, card)}
    runs = []
    for _ in range(2):
        xs = x.clone().requires_grad_(True)
        ws = {k: (0.1 * v).to(torch.bfloat16).requires_grad_(True) for k, v in w.items()}
        out = moe_block(xs, ws, top_k=2, capacity_factor=1.0, router_style="softmax_topk")
        (out.y.float().square().sum() + out.load_balance_loss + out.router_z_loss).backward()
        runs.append([out.y, xs.grad] + [ws[k].grad for k in sorted(ws)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# The SSM, hybrid, VLM and audio architectures
# ---------------------------------------------------------------------------

NEW_ARCHS = ["mamba2-1.3b", "hymba-1.5b", "internvl2-1b", "whisper-small"]


@pytest.mark.parametrize("shape,packed", [((3, 32, 50), True), ((192, 8, 2048), False),
                                          ((24, 8, 24), False), ((48, 128, 2048), False)])
def test_fused_chain_at_the_ssm_unit_shapes_matches_plain(card, shape, packed):
    """hymba's whole (32, 50) per-head scalar units (a 200-byte row stride,
    which TMA cannot take: packed), mamba2's 8 x 2048 wdt blocks and 8 x 24
    per-head scalar blocks of an 8-way grid at 24 layers, and its whole
    128 x 2048 wb / wc units."""
    x = _rand(shape, 70, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), fused.ns_chain_plain(x, PAPER_COEFFS, 5),
                CHAIN_TOL)
    assert fused.ns_chain.launches == 1 and fused.ns_chain.packed_launches == int(packed)


def _small_arch(arch, device):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(arch).reduced()
    return cfg, tree_lib.tree_map(lambda p: p.to(device), init_params(cfg, seed=0, device="cpu"))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_arch_training_on_the_card_tracks_the_cpu(card, arch):
    from repro_torch.launch import train

    _, base = _small_arch(arch, "cpu")
    argv = ["--arch", arch, "--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32"]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    gpu = train.run(argv + ["--device", "cuda"], params=_small_arch(arch, card)[1]).records
    assert kernels.launch_counts()["ns_fused_chain"] > 0
    # fp32, 1e-3 of each loss as the dense run's above.
    assert max(abs(g["loss"] - c["loss"]) / max(1.0, abs(c["loss"]))
               for g, c in zip(gpu, cpu)) <= 1e-3


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_arch_decode_on_the_card_tracks_the_cpu(card, arch):
    """Prefill and eight decode steps on an fp32 cache, and greedy generate
    tokens, card against CPU: logits to 1e-4, tokens equal."""
    from repro_torch.models.encdec import encode
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.serve_step import cache_from_prefill, generate

    gen = torch.Generator().manual_seed(3)
    cfg, _ = _small_arch(arch, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    extras = {}
    if cfg.vision_tokens:
        extras["vision_embeds"] = 0.1 * torch.randn((2, cfg.vision_tokens, cfg.d_model),
                                                    generator=gen)
    if cfg.encoder_seq:
        extras["audio_frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                                   generator=gen)
    V = cfg.vision_tokens
    outs, toks = {}, {}
    for device in ("cpu", card):
        cfg, params = _small_arch(arch, device)
        ex = {k: v.to(device) for k, v in extras.items()}
        with torch.no_grad():
            logits_p, pcache = prefill(params, {"tokens": tokens[:, :8].to(device), **ex}, cfg)
            cache = cache_from_prefill(pcache, cfg, V + 16, dtype=torch.float32)
            enc = encode(params["encoder"], ex["audio_frames"], cfg) if cfg.encoder_seq else None
            steps = [logits_p]
            for t in range(8, 16):
                steps.append(decode_step(params, tokens[:, t:t + 1].to(device), cache, V + t,
                                         cfg, encoder_out=enc)[0])
        outs[str(device)] = steps
        toks[str(device)] = generate(params, tokens[:, :8].to(device), cfg, max_new_tokens=8,
                                     max_len=V + 16, batch_extras=ex or None).cpu()
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert b.is_cuda and float((b.cpu() - a).abs().max()) <= 1e-4
    assert torch.equal(toks["cpu"], toks[str(card)])


# The fused chain at the local block shapes of the distributed engine:
# full-width muonbp-960m on data=2,model=2 with ZeRO-1 (wk/wv 12 x 192 x
# 1536, wq/wo 6 x 768 x 1536, the norm gains 2 x 12 x 1536, on the small
# side), and the flatten fallback's 3 padded-to-4 layers.
@pytest.mark.parametrize("shape", [(12, 192, 1536), (6, 768, 1536), (2, 12, 1536),
                                   (4, 192, 1536), (2, 768, 1536), (2, 3, 1536)])
def test_fused_chain_at_the_engine_block_shapes_matches_plain(card, shape):
    x = _rand(shape, 31, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), fused.ns_chain_plain(x, PAPER_COEFFS, 5),
                CHAIN_TOL)


def _gloo_rank(rank, port, queue):
    """One rank of a 2-rank gloo world on the one card: a full and a block
    step of the reduced model through the engine, updates gathered to full."""
    import traceback

    import torch.distributed as dist

    try:
        from repro_torch import tree as tree_lib
        from repro_torch.distributed import make_engine
        from repro_torch.launch.mesh import make_mesh_from_spec

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2)
        mesh = make_mesh_from_spec("model=2")
        params, grads, opt, engine = _engine_case(mesh, make_engine)
        state = opt.init(params)
        outs = []
        for phase in ("full", "block"):
            upd, state = opt.update(grads, state, params, phase)
            # numpy, not tensors: a tensor on a queue is shared through this
            # process, which may have exited when the parent reads it.
            outs.append({k: engine.replicate(k, engine.to_param_layout(k, u)).cpu().numpy()
                         for k, u in tree_lib.flatten_with_path(upd)})
        queue.put((rank, outs if rank == 0 else None))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def _engine_case(mesh, make_engine=None):
    """The reduced muonbp-960m on the card, seeded gradients, combine(muon,
    adamw) on ``mesh``'s block grid; with ``make_engine``, on an engine over
    ``mesh`` (returned last)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core import adamw, combine, label_tree, muon
    from repro_torch.launch.train import matrix_block_specs
    from repro_torch.models.model import init_params
    from repro_torch.sharding import specs as sh

    cfg = get_config("muonbp-960m").reduced()
    sizes = sh.mesh_axis_sizes(mesh)
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = tree_lib.tree_map(
        lambda p: torch.randn(p.shape, generator=gen, device="cuda"), params)
    comm = make_engine(params, sh.param_specs(params, cfg, sizes), mesh) if make_engine else None
    opt = combine({"muon": muon(0.02, 0.02, period=5, weight_decay=0.1, comm=comm,
                                block_specs=matrix_block_specs(params, cfg, sizes)),
                   "adamw": adamw(0.008, weight_decay=0.1, comm=comm)}, label_tree(params))
    return params, grads, opt, comm


def test_gloo_world_of_two_on_the_card_matches_one_process(card):
    """Two ranks share the card (gloo): the engine's full and block updates
    against the single-process update from the kernels, CHAIN_TOL."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch import tree as tree_lib

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_gloo_rank, args=(port, queue), nprocs=2,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(2))
    procs.join()
    for rank, res in results.items():
        assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
    params, grads, opt, _ = _engine_case({"model": 2})
    state = opt.init(params)
    for phase, got in zip(("full", "block"), results[0]):
        upd, state = opt.update(grads, state, params, phase)
        for k, ref in tree_lib.flatten_with_path(upd):
            _assert_rel(torch.from_numpy(got[k]).cuda(), ref, CHAIN_TOL)


def _gloo_tp_rank(rank, port, queue):
    """One rank of a 2-rank gloo world on the one card, tensor-parallel on
    ``model=2``: whether gloo's own reduce-scatter takes CUDA tensors, then
    the reduced dense model's loss and gradients (fp32) on this rank's
    shards."""
    import traceback

    import torch.distributed as dist

    try:
        from repro_torch import interop
        from repro_torch.configs import get_config
        from repro_torch.distributed import make_engine
        from repro_torch.launch.mesh import make_mesh_from_spec
        from repro_torch.models.model import init_params
        from repro_torch.sharding import specs as sh
        from repro_torch.training.train_step import loss_and_grads, reduce_grads

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2)
        out = torch.empty(2, device="cuda")
        try:
            scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
            scatter(out, torch.ones(4, device="cuda"))
            native = bool(torch.equal(out.cpu(), torch.full((2,), 2.0)))
        except (RuntimeError, ValueError, NotImplementedError):
            native = False
        mesh = make_mesh_from_spec("model=2")
        cfg = get_config("muonbp-960m").reduced()
        full = init_params(cfg, seed=0, device="cuda")
        engine = make_engine(full, sh.param_specs(full, cfg, {"model": 2}), mesh,
                             tensor_parallel=True)
        params = interop.shard_params(full, cfg, {"model": 2}, engine.comm.coords, "cuda")
        ctx = sh.make_ctx(cfg, engine, seq=32)
        batch = _tp_batch(cfg, "cuda")
        loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32, ctx=ctx)
        reduce_grads(engine, loss, metrics, grads, ctx)
        queue.put((rank, {"native": native, "loss": float(loss), "coords": engine.comm.coords,
                          "grads": interop.params_to_numpy(grads)}))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def _tp_batch(cfg, device):
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], dim=1)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}


def test_gloo_tensor_parallel_step_on_the_card_matches_the_cpu(card):
    """Two ranks share the card (gloo), tensor-parallel: gloo's own
    reduce-scatter takes CUDA tensors (the collectives issue it), and the
    loss and joined gradients equal the single-process CPU port's (fp32,
    relative 1e-5 and 1e-5 of max|grad|)."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch import interop
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_step import loss_and_grads

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_gloo_tp_rank, args=(port, queue), nprocs=2,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(2))
    procs.join()
    for rank, res in results.items():
        assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
    assert results[0]["native"] and results[1]["native"]
    cfg = get_config("muonbp-960m").reduced()
    full = init_params(cfg, seed=0, device="cuda")
    cpu = tree_lib.tree_map(lambda p: p.cpu(), full)
    loss, _, grads = loss_and_grads(cpu, _tp_batch(cfg, "cpu"), cfg, torch.float32)
    assert abs(results[0]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    assert results[1]["loss"] == results[0]["loss"]
    specs = sh.param_specs(cpu, cfg, {"model": 2})
    joined = dict(tree_lib.flatten_with_path(interop.join_params(
        [(r["coords"], r["grads"]) for r in results.values()], specs, {"model": 2})))
    for k, ref in tree_lib.flatten_with_path(interop.params_to_numpy(grads)):
        assert float(np.abs(joined[k] - ref).max()) <= 1e-5 * float(np.abs(ref).max()), k


MOE_TP_ARGV = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
               "32", "--period", "2", "--compute-dtype", "float32", "--schedule", "const"]


def _moe_tp_weights():
    """The reduced olmoe-1b-7b's weights from seed 0, drawn on the CPU (the
    card's generator draws other numbers from the same seed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    return init_params(get_config("olmoe-1b-7b").reduced(), seed=0, device="cpu")


def _gloo_moe_tp_rank(rank, port, queue):
    """One rank of a 2-rank gloo world on the one card: the launcher trains
    the reduced olmoe-1b-7b tensor-parallel on ``model=2`` (each rank its
    half of every expert's d_ff), on CUDA tensors."""
    import os
    import traceback

    import torch.distributed as dist

    try:
        from repro_torch import tree as tree_lib
        from repro_torch.launch import train

        torch.backends.cuda.matmul.allow_tf32 = False
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2)
        params = tree_lib.tree_map(lambda p: p.to("cuda"), _moe_tp_weights())
        run = train.run(MOE_TP_ARGV + ["--mesh", "model=2"], params=params)
        queue.put((rank, {"tensor_parallel": run.engine.tensor_parallel,
                          "wi": tuple(run.state.params["layers"]["moe"]["wi"].shape),
                          "device": str(run.state.params["layers"]["moe"]["wi"].device),
                          "records": [{k: r[k] for k in ("loss", "load_balance", "z_loss")}
                                      for r in run.records]}))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def test_gloo_moe_tensor_parallel_training_on_the_card_tracks_the_cpu(card):
    """Two ranks share the card (gloo) and train the reduced olmoe-1b-7b
    tensor-parallel through the launcher, the kernels on the expert shards:
    the loss and both aux metrics of every step within 1e-3 (relative) of
    one CPU process's run from the same weights (seed 0) on the same block
    grid."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_gloo_moe_tp_rank, args=(port, queue), nprocs=2,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(2))
    procs.join()
    for rank, res in results.items():
        assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
    cfg = get_config("olmoe-1b-7b").reduced()
    cpu = train.run(MOE_TP_ARGV + ["--device", "cpu", "--mesh-model", "2"],
                    params=_moe_tp_weights())
    for res in results.values():
        assert res["tensor_parallel"] and res["device"].startswith("cuda")
        assert res["wi"] == (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff // 2)
        assert res["records"] == results[0]["records"]
        for got, ref in zip(res["records"], cpu.records):
            for k, v in got.items():
                assert abs(v - ref[k]) <= 1e-3 * abs(ref[k]), (k, v, ref[k])
