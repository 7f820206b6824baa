"""The distributed MuonBP engine's ZeRO-1 flatten fallback and multi-pod
mesh on one multi-process ``gloo`` world on the CPU.

One world of four ranks, spawned once a module, runs two meshes in turn:
``data=2,model=2`` with the ZeRO-1 flatten fallback at 3 layers (NorMuon,
padded row statistics) and ``pod=2,model=2`` with ZeRO-1 over ``pod``
(Turbo-Muon). The checks, their setup and tolerances are
``tests/test_torch_distributed.py``'s, run here on these two meshes.
"""

import pytest
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from test_torch_distributed import (  # noqa: F401  (the checks, run on this module's worlds)
    run_worlds,
    test_dion_on_a_mesh_raises,
    test_engine_update_matches_reference_single_device,
    test_engine_update_matches_single_process,
    test_launcher_on_a_mesh_matches_one_process,
    test_make_local_mesh_spans_the_world,
    test_momentum_shards_and_pad_layers,
    test_multi_axis_gather_and_cut,
    test_pipelined_equals_barrier,
    test_snapshots_cross_between_mesh_and_one_process,
    test_trace_matches_plan_to_the_byte,
)

NAMES = ("data2_model2_flatten", "pod2_model2")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_worlds(NAMES, tmp_path_factory)


@pytest.fixture(scope="module", params=NAMES)
def world_run(request, world):
    return world[request.param]
