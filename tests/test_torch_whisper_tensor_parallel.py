"""The tensor-parallel whisper on multi-process ``gloo`` worlds on the CPU.

The worlds, checks, setup and tolerances are
``tests/test_torch_vlm_audio_tensor_parallel.py``'s, run here on whisper's
configs: the reduced whisper-small, its 64-frame encoder sequence-sharded on
``model`` 2 and 4, and the same with 63 frames, which neither axis divides,
so that the encoder's leaves' gradients are whole on each rank while the
decoder's residual is sequence-sharded; and the launcher on
``data=2,model=2``.
"""

import pytest
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from test_torch_vlm_audio_tensor_parallel import (  # noqa: F401  (the checks, run here)
    LAUNCH_CONFIGS,
    cases_of,
    reference_params,
    spawn_worlds,
    test_gradients_match_reference,
    test_launcher_trains_tensor_parallel,
    test_layouts_follow_the_reference_rules,
    test_logits_match_reference,
    test_loss_matches_reference,
    test_mesh_bytes_predicts_the_launcher_trace,
    test_trace_equals_tp_bytes_and_the_plan,
    test_updates_match_reference,
)

MODULE_CONFIGS = ("whisper", "whisper_enc63")


@pytest.fixture(scope="module")
def params_np():
    return reference_params(MODULE_CONFIGS)


@pytest.fixture(scope="module")
def worlds(params_np):
    """Every world's results, the worlds spawned together, once."""
    return spawn_worlds(MODULE_CONFIGS, params_np)


@pytest.fixture(scope="module", params=cases_of(MODULE_CONFIGS))
def case(request):
    return request.param


@pytest.fixture(scope="module", params=[c for c in LAUNCH_CONFIGS if c in MODULE_CONFIGS])
def launch_config(request):
    return request.param
