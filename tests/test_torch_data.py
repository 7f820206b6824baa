"""The port's data pipeline against the reference's: streams and their positions.

Both packages draw from numpy only, so one seed must give equal token
streams, and a stream position saved by either (``state()``, the dict a
checkpoint's ``meta.json`` carries) must resume the other exactly.
"""

import json
import os

import numpy as np
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.data.pipeline import MemmapDataset as JMemmapDataset
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import unigram_entropy as j_unigram_entropy
from repro_torch.configs import get_config
from repro_torch.data import MemmapDataset, SyntheticLM, unigram_entropy


def _cfgs():
    return get_config("muonbp-960m").reduced(), j_get_config("muonbp-960m").reduced()


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_streams_equal_the_reference_for_one_seed():
    cfg, jcfg = _cfgs()
    port, ref = iter(SyntheticLM(cfg, 4, 32, seed=7)), iter(JSyntheticLM(jcfg, 4, 32, seed=7))
    for _ in range(3):
        _equal(next(port), next(ref))


def test_stream_positions_cross_between_the_packages():
    cfg, jcfg = _cfgs()
    port_src, ref_src = SyntheticLM(cfg, 4, 32, seed=3), JSyntheticLM(jcfg, 4, 32, seed=3)
    port, ref = iter(port_src), iter(ref_src)
    for _ in range(2):
        next(port), next(ref)
    assert json.dumps(port_src.state()) == json.dumps(ref_src.state())
    fresh_port, fresh_ref = SyntheticLM(cfg, 4, 32, seed=3), JSyntheticLM(jcfg, 4, 32, seed=3)
    fresh_port.set_state(json.loads(json.dumps(ref_src.state())))
    fresh_ref.set_state(json.loads(json.dumps(port_src.state())))
    want = next(port)
    _equal(next(iter(fresh_port)), want)
    _equal(next(iter(fresh_ref)), want)


def test_synthetic_state_roundtrip():
    cfg, _ = _cfgs()
    pipe = SyntheticLM(cfg, 4, 32, seed=7)
    it = iter(pipe)
    for _ in range(3):
        next(it)
    saved = pipe.state()
    want = [next(it) for _ in range(2)]
    fresh = SyntheticLM(cfg, 4, 32, seed=7)
    fresh.set_state(saved)
    it2 = iter(fresh)
    for a in want:
        _equal(next(it2), a)


def test_labels_are_next_tokens_and_streams_differ_by_seed():
    cfg, _ = _cfgs()
    a = next(iter(SyntheticLM(cfg, 2, 16, seed=0)))
    assert a["tokens"].shape == a["labels"].shape == (2, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"], next(iter(SyntheticLM(cfg, 2, 16, seed=1)))["tokens"])


def test_unigram_entropy_matches_the_reference():
    cfg, jcfg = _cfgs()
    h = unigram_entropy(SyntheticLM(cfg, 8, 64, seed=0))
    assert h == j_unigram_entropy(JSyntheticLM(jcfg, 8, 64, seed=0))
    assert h > np.log(8)  # well above what a bigram model can reach


def test_memmap_dataset_matches_the_reference_and_resumes(tmp_path):
    path = os.path.join(tmp_path, "tokens.bin")
    (np.arange(4000, dtype=np.uint16) % 128).tofile(path)
    port, ref = MemmapDataset(path, 4, 16, seed=3), JMemmapDataset(path, 4, 16, seed=3)
    it, jt = iter(port), iter(ref)
    first = next(it)
    _equal(first, next(jt))
    np.testing.assert_array_equal(first["tokens"][:, 1:], first["labels"][:, :-1])
    saved = json.loads(json.dumps(port.state()))
    want = next(it)
    again = MemmapDataset(path, 4, 16, seed=3)
    again.set_state(saved)
    _equal(next(iter(again)), want)
    _equal(next(jt), want)
