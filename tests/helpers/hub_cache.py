"""A local Hugging Face hub cache for the fetch tests, with no network.

``offline_hub`` points ``huggingface_hub`` at a temporary cache and keeps
it off the network three ways: ``HF_HUB_OFFLINE`` in the environment and
in the library's constants (read once, at its import), and every
``snapshot_download`` called with ``local_files_only=True``, so the
cache is the only source whatever the library's session state.
``fake_snapshot`` writes a repository's files into that cache as a
download leaves them: ``refs/main`` naming a commit whose snapshot
folder holds the files."""

import functools
import os
import shutil


def offline_hub(monkeypatch, cache_dir) -> None:
    import huggingface_hub
    from huggingface_hub import constants

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(cache_dir))
    monkeypatch.setattr(huggingface_hub, "snapshot_download", functools.partial(
        huggingface_hub.snapshot_download, local_files_only=True))


def fake_snapshot(cache_dir, repo_id: str, src_dir, commit: str = "0" * 40) -> str:
    """Copy the files of ``src_dir`` into the cache as ``repo_id``'s
    snapshot at ``commit``; the snapshot folder."""
    repo = os.path.join(str(cache_dir), "models--" + repo_id.replace("/", "--"))
    snap = os.path.join(repo, "snapshots", commit)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(commit)
    shutil.copytree(str(src_dir), snap)
    return snap
