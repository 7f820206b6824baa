"""Prefill and decode of sub-blocks a model axis leaves whole, on ``model=2``
and ``model=4`` ``gloo`` worlds on the CPU.

The harness, checks and tolerances are ``tests/test_torch_tp_decode.py``'s,
run here on its worlds ``model2_whole`` and ``model4_whole``
(``sharding.specs.whole_sub_blocks``): on ``model=2`` a ``d_ff`` of 511
(the MLP whole beside split attention) and a padded vocab of 511 (the
plain lookup, logits and argmax on every rank; gemma2-9b's tied embedding
and softcaps; internvl2's vision rows ahead of the text); on ``model=4``
K/V heads of 30 with Q in 'head' (the cache holds every KV head on every
rank, each rank's Q heads attend over theirs) and Q and K/V whole (every
rank attends over every head with the whole ``wo``), each also with the
cache's sequence over ``model``, olmoe's experts whole (expert ``d_ff`` 6),
mamba2 with a ``d_inner`` of 198 (its state whole on every rank), hymba's
SSM whole beside split attention and hymba with every sub-block whole, on
its ring, and whisper with its heads and ``d_ff`` whole. Prompts of 12
tokens shard the prefill's residual on both axes, of 11 do not.
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

MODULE_WORLDS = ("model2_whole", "model4_whole")


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
