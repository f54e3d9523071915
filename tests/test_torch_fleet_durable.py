"""har_tpu_torch.utils.durable — THE fsync discipline behind the model
registry and the fleet journal, previously exercised only indirectly
through them.  These tests pin the three helpers directly: the
tmp→fsync→rename→dir-fsync ordering of ``atomic_write``, the
first-append directory sync of ``durable_append``, and the behavior
under an injected ``os.fsync`` failure (the old content must survive —
durability errors may lose the NEW write, never the previous state).
"""

import os

import pytest

import har_tpu_torch.utils.durable as durable
from har_tpu_torch.utils.durable import atomic_write, durable_append, fsync_dir


def test_atomic_write_round_trip(tmp_path):
    target = tmp_path / "CURRENT"
    atomic_write(str(target), "v1")
    assert target.read_text() == "v1"
    atomic_write(str(target), "v2")
    assert target.read_text() == "v2"
    # no tmp residue after a clean write
    assert sorted(p.name for p in tmp_path.iterdir()) == ["CURRENT"]


def test_atomic_write_orders_fsync_before_rename(tmp_path, monkeypatch):
    """The discipline's whole point: data fsync happens BEFORE the
    rename makes it visible, and the parent directory is synced AFTER
    — a reader sees old-or-new, and whichever it sees survives."""
    events = []
    real_fsync = os.fsync
    real_replace = os.replace

    monkeypatch.setattr(
        durable.os, "fsync",
        lambda fd: (events.append("fsync"), real_fsync(fd))[1],
    )
    monkeypatch.setattr(
        durable.os, "replace",
        lambda a, b: (events.append("replace"), real_replace(a, b))[1],
    )
    monkeypatch.setattr(
        durable, "fsync_dir", lambda p: events.append("fsync_dir")
    )
    atomic_write(str(tmp_path / "ptr"), "x")
    assert events == ["fsync", "replace", "fsync_dir"]


def test_atomic_write_fsync_failure_preserves_old_content(
    tmp_path, monkeypatch
):
    target = tmp_path / "NEXT_ID"
    atomic_write(str(target), "7")

    def boom(fd):
        raise OSError("injected fsync failure (disk pulled)")

    monkeypatch.setattr(durable.os, "fsync", boom)
    with pytest.raises(OSError, match="injected fsync failure"):
        atomic_write(str(target), "8")
    # the failed write never reached the target: old content intact
    assert target.read_text() == "7"


def test_durable_append_accumulates_and_fsyncs(tmp_path, monkeypatch):
    log = tmp_path / "promotions.jsonl"
    n_fsync = [0]
    real_fsync = os.fsync
    monkeypatch.setattr(
        durable.os, "fsync",
        lambda fd: (n_fsync.__setitem__(0, n_fsync[0] + 1),
                    real_fsync(fd))[1],
    )
    durable_append(str(log), "a\n")
    durable_append(str(log), "b\n")
    assert log.read_text() == "a\nb\n"
    assert n_fsync[0] >= 2  # every append syncs the data


def test_durable_append_syncs_dir_only_on_first_append(
    tmp_path, monkeypatch
):
    dir_syncs = []
    monkeypatch.setattr(
        durable, "fsync_dir", lambda p: dir_syncs.append(p)
    )
    log = tmp_path / "log.jsonl"
    durable_append(str(log), "first\n")
    assert len(dir_syncs) == 1  # new dir entry must be made durable
    durable_append(str(log), "second\n")
    assert len(dir_syncs) == 1  # existing entry: no extra dir sync


def test_durable_append_fsync_failure_propagates(tmp_path, monkeypatch):
    """A failed append must RAISE (the registry's promote would then
    refuse to claim the transition durable), never silently succeed."""
    log = tmp_path / "log.jsonl"
    durable_append(str(log), "ok\n")
    monkeypatch.setattr(
        durable.os, "fsync",
        lambda fd: (_ for _ in ()).throw(OSError("injected")),
    )
    with pytest.raises(OSError):
        durable_append(str(log), "lost?\n")
    # pre-failure content still readable
    assert log.read_text().startswith("ok\n")


def test_fsync_dir_tolerates_unopenable_directory(monkeypatch):
    """Platforms without directory fds (the documented escape): the
    helper degrades silently instead of breaking every atomic write."""
    monkeypatch.setattr(
        durable.os, "open",
        lambda *a, **k: (_ for _ in ()).throw(OSError("no dir fds")),
    )
    fsync_dir("/definitely/anywhere")  # must not raise
