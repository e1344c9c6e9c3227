"""The port's ``ingest_stats.json`` and ``rank_status.json`` loaders
against the JAX package's (``reporting/loaders.py``).

Both cache each file by (mtime, size): an unchanged file is parsed once
(a second call returns the same object), a rewrite that changes the
stamp is read again, and a missing or unreadable file gives ``{}``.  The
port's loaders return what the JAX ones return at every step.
"""

import json
import os

import pytest

from traceml_tpu.reporting import loaders as jax_loaders
from traceml_tpu_torch.reporting import loaders

FILES = {"load_ingest_stats": "ingest_stats.json", "load_rank_status": "rank_status.json"}


@pytest.mark.parametrize("name", sorted(FILES))
def test_loader_caches_by_mtime_and_size_like_jax(tmp_path, name):
    ours, theirs = getattr(loaders, name), getattr(jax_loaders, name)
    path = tmp_path / FILES[name]
    assert ours(tmp_path) == theirs(tmp_path) == {}  # missing

    path.write_text(json.dumps({"envelopes_ingested": 10, "ranks": {"0": {"state": "active"}}}))
    first = ours(tmp_path)
    assert first == theirs(tmp_path) and first["envelopes_ingested"] == 10
    assert ours(tmp_path) is first  # a hit: not parsed again
    assert theirs(tmp_path) is theirs(tmp_path)

    # the same size and mtime: both keep serving the cached object
    stamp = path.stat()
    path.write_text(json.dumps({"envelopes_ingested": 20, "ranks": {"0": {"state": "active"}}}))
    os.utime(path, ns=(stamp.st_atime_ns, stamp.st_mtime_ns))
    assert ours(tmp_path) is first and theirs(tmp_path)["envelopes_ingested"] == 10

    # a rewrite that changes the stamp is read again
    path.write_text(json.dumps({"envelopes_ingested": 300, "final": True}))
    second = ours(tmp_path)
    assert second == theirs(tmp_path) == {"envelopes_ingested": 300, "final": True}
    assert second is not first

    path.write_text("{not json")
    assert ours(tmp_path) == theirs(tmp_path) == {}  # unreadable
    path.write_text("[1, 2]")
    assert ours(tmp_path) == theirs(tmp_path) == {}  # not an object
    path.unlink()
    assert ours(tmp_path) == theirs(tmp_path) == {}
