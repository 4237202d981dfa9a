"""Streaming per-worker tar.gz shard writer + shard merger.

Reference: src/lancet/base/tar_gz_writer.{h,cpp} and
src/lancet/core/tar_gz_shard_merger.{h,cpp} — every worker streams its graph
snapshots into its own gzipped TAR shard; after the run the shards are
merged into one archive (on merge failure, shards stay on disk for manual
recovery — same contract here).
"""

from __future__ import annotations

import io
import os
import tarfile
import time


class TarGzWriter:
    """Append-only gzipped TAR archive of in-memory files."""

    def __init__(self, path: str):
        self.path = path
        self._tar = tarfile.open(path, "w:gz")

    def add_file(self, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name=name)
        info.size = len(data)
        info.mtime = int(time.time())
        self._tar.addfile(info, io.BytesIO(data))

    def close(self) -> None:
        self._tar.close()


def merge_shards(shard_paths: list[str], out_path: str, remove_shards: bool = True) -> int:
    """Merge per-worker shards into one archive; returns entry count.

    On failure the input shards are preserved for manual recovery.
    """
    count = 0
    try:
        with tarfile.open(out_path, "w:gz") as out:
            for shard in shard_paths:
                if not os.path.exists(shard):
                    continue
                with tarfile.open(shard, "r:gz") as src:
                    for member in src:
                        fh = src.extractfile(member)
                        if fh is None:
                            continue
                        out.addfile(member, fh)
                        count += 1
    except Exception:
        raise
    if remove_shards:
        for shard in shard_paths:
            if os.path.exists(shard):
                os.unlink(shard)
    return count
