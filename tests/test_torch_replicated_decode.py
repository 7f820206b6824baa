"""Prefill and decode on meshes without a model split, ``data=2`` and
``data=4,model=1`` ``gloo`` worlds on the CPU.

The harness, checks and tolerances are ``tests/test_torch_tp_decode.py``'s,
run here on its worlds ``data2`` and ``data4_model1``: the context carries
the reference's decode layout (``sharding.specs.cache_specs``) and no
model split. Four rows split over the data axes: each rank prefills and
decodes its rows on the one-device model, its cache every position. A
batch of one splits the cache's sequence over the data axes: every rank
computes the same prefill and keeps its positions (no collective), and
each decode step merges the ranks' softmax over their keys
(``tensor_parallel.merge_softmax``), the only collective: dense, gemma2's
softcaps and alternating window, internvl2's vision rows, mixtral's and
hymba's rings split over the data axes, mamba2 and whisper. The logits
are every vocab column on every rank.
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

MODULE_WORLDS = ("data2", "data4_model1")


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
