"""Tensor-parallel prefill and decode on ``model=4`` and ``data=2,model=2``
``gloo`` worlds on the CPU.

The harness, checks and tolerances are ``tests/test_torch_tp_decode.py``'s,
run here on its other worlds: on ``model=4`` the reduced GQA configs' K/V
in 'hd' with Q in 'head' (the cache's head_dim slices gathered each step),
the cache's sequence over ``model`` (kv_seq_shard; gemma2-9b's window and
softcaps on it, and mixtral's ring split into quarters of its 8 slots), hymba with its SSM heads whole on every
rank (d_model 96: six heads that 4 does not divide) on a ring, internvl2;
on ``data=2,model=2`` the rows over ``data`` with the cache's sequence over
``model``, a batch of one whose cache splits its sequence over ``data``
(hymba's ring too), mamba2, olmoe routed per data shard, and whisper.
"""

import pytest
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from test_torch_tp_decode import (  # noqa: F401  (the checks, run here)
    cases_of,
    reference_params,
    references,
    spawn_worlds,
    test_cache_shards_match_reference,
    test_each_rank_holds_its_cache_specs_shard,
    test_greedy_tokens_match_reference,
    test_layouts_follow_cache_specs,
    test_prefill_and_decode_logits_match_reference,
    test_trace_equals_tp_bytes_and_mesh_bytes,
)

MODULE_WORLDS = ("model4", "data2_model2")


@pytest.fixture(scope="module")
def params_np():
    return reference_params(MODULE_WORLDS)


@pytest.fixture(scope="module")
def worlds(params_np):
    """Every world's results, the worlds spawned together, once."""
    return spawn_worlds(MODULE_WORLDS, params_np)


@pytest.fixture(scope="module")
def refs(params_np):
    return references(MODULE_WORLDS, params_np)


@pytest.fixture(scope="module", params=cases_of(MODULE_WORLDS))
def case(request):
    return request.param
