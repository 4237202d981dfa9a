"""Cloud URI detection, upfront access validation, injectable transports.

Reference parity surface: hts/uri_utils.{h,cpp} detects s3/gs/http/ftp URIs
and validates cloud credentials upfront (a zero-byte PUT) so a 40-hour run
cannot fail at the final VCF flush (reference: cli/pipeline_runner.cpp:
244-257); hts/extractor.cpp streams BAM/CRAM straight from cloud URIs via
htslib's hfile plugins.

This build runs in a zero-egress environment, so the actual network
backends cannot be exercised — the IO path is therefore built around an
injectable *transport* registry: anything that can `size`/`read_range`/
`write` a URI can be registered per scheme (s3, gs, http, ...), and the
whole hts layer opens files through `hts_open`, which dispatches cloud URIs
to the registered transport's ranged reader / buffered writer. Tests
register an in-memory transport (`MemTransport`) and drive BAM reads and
bgzip VCF writes through it end-to-end; a production deployment registers
a real client (boto3 / google-cloud-storage / httpx) with the same three
methods and nothing else changes.
"""

from __future__ import annotations

import io

CLOUD_SCHEMES = ("s3://", "gs://", "http://", "https://", "ftp://")

# scheme (without '://') -> transport object
_TRANSPORTS: dict[str, object] = {}


def is_cloud_uri(path: str) -> bool:
    return path.startswith(CLOUD_SCHEMES)


def register_transport(scheme: str, transport) -> None:
    """Register a transport for a URI scheme ('s3', 'gs', 'http', ...).

    A transport implements:
      size(path) -> int                     total object size (read preflight)
      read_range(path, start, length) -> bytes
      write(path, data: bytes) -> None      whole-object put
    and optionally preflight_write(path) (defaults to a zero-byte write of
    `path + '.preflight'`, mirroring the reference's zero-byte PUT check).
    """
    _TRANSPORTS[scheme] = transport


def unregister_transport(scheme: str) -> None:
    _TRANSPORTS.pop(scheme, None)


def get_transport(path: str):
    scheme, sep, _ = path.partition("://")
    if not sep:
        return None
    t = _TRANSPORTS.get(scheme)
    if t is None:
        t = _auto_transport(scheme)  # http/https work out of the box
    return t


def scheme_served_here(path: str) -> str | None:
    """The scheme of `path` if a transport registered in this process serves
    it: any registered scheme but the http/https transports that
    `get_transport` builds by itself. The registry is process memory, so a
    spawned interpreter (the batch executor's prep coordinator) has no
    transport for such a scheme and cannot open the path."""
    scheme, sep, _ = path.partition("://")
    if not sep:
        return None
    transport = _TRANSPORTS.get(scheme)
    if transport is None or (scheme in ("http", "https")
                             and type(transport) is HttpTransport):
        return None
    return scheme


def validate_uri_shape(path: str) -> None:
    """Raise ValueError for malformed cloud URIs (scheme but no bucket/key)."""
    if not is_cloud_uri(path):
        return
    scheme, _, rest = path.partition("://")
    if scheme in ("s3", "gs"):
        bucket, _, key = rest.partition("/")
        if not bucket or not key:
            raise ValueError(
                f"malformed {scheme}:// URI {path!r}: expected "
                f"{scheme}://bucket/key"
            )
    elif not rest:
        raise ValueError(f"malformed URI {path!r}")


def validate_cloud_access(paths: list[str], mode: str = "read") -> None:
    """Upfront fail-fast gate for any cloud URI among `paths`.

    With a registered transport this performs the reference's preflight for
    real: reads check object existence/size, writes do a zero-byte PUT
    (reference: cli/pipeline_runner.cpp:244-257). Without one it reports
    the missing backend immediately (same fail-fast contract).
    """
    remote = [p for p in paths if is_cloud_uri(p)]
    for p in remote:
        validate_uri_shape(p)
        transport = get_transport(p)
        if transport is None:
            raise SystemExit(
                "cloud URIs detected but no transport is registered for "
                f"their scheme ({mode}: {p}). Register one via "
                "lancet2_tpu_torch.hts.uri.register_transport, or download "
                "inputs locally and pass local paths."
            )
        try:
            if mode == "read":
                transport.size(p)
            else:
                preflight = getattr(transport, "preflight_write", None)
                if preflight is not None:
                    preflight(p)
                else:
                    transport.write(p + ".preflight", b"")
        except Exception as exc:
            raise SystemExit(
                f"cloud {mode} preflight failed for {p}: {exc}"
            ) from exc


class RangedReader(io.RawIOBase):
    """Seekable read-only file object over a transport's ranged reads.

    Wrapped in io.BufferedReader by hts_open, so small sequential reads
    (BGZF block headers etc.) coalesce into `block_size` ranged requests —
    the same access pattern htslib's hfile_s3 uses.
    """

    def __init__(self, transport, path: str, block_size: int = 4 << 20):
        self._t = transport
        self._path = path
        self._size = int(transport.size(path))
        self._pos = 0
        self._block = block_size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        if self._pos >= self._size:
            return 0
        n = min(len(b), self._size - self._pos, self._block)
        data = self._t.read_range(self._path, self._pos, n)
        b[: len(data)] = data
        self._pos += len(data)
        return len(data)


class TransportWriter(io.RawIOBase):
    """Write-only file object buffering into memory, PUT on close.

    Transports exposing `write_stream(path) -> file-like` can stream
    (multipart) instead; this default keeps the whole object in memory,
    which is fine for VCF outputs (bgzip-compressed).
    """

    def __init__(self, transport, path: str):
        self._t = transport
        self._path = path
        self._buf = io.BytesIO()

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        return self._buf.write(b)

    def close(self) -> None:
        if not self.closed:
            self._t.write(self._path, self._buf.getvalue())
        super().close()


def hts_open(path: str, mode: str = "rb"):
    """Open a local path or cloud URI for binary IO.

    Every file open in the hts layer goes through here (reference parity:
    htslib hopen/hfile URI dispatch, hts/extractor.cpp)."""
    if not is_cloud_uri(path):
        return open(path, mode)
    transport = get_transport(path)
    if transport is None:
        raise SystemExit(
            f"no transport registered for cloud URI {path!r}; register one "
            "via lancet2_tpu_torch.hts.uri.register_transport"
        )
    if "r" in mode:
        reader = io.BufferedReader(RangedReader(transport, path))
        if "b" not in mode:
            return io.TextIOWrapper(reader)
        return reader
    stream = getattr(transport, "write_stream", None)
    writer = stream(path) if stream is not None else TransportWriter(transport, path)
    if "b" not in mode:
        return io.TextIOWrapper(writer)
    return writer


class MemTransport:
    """In-memory transport (tests / loopback): blobs dict keyed by URI."""

    def __init__(self, blobs: dict[str, bytes] | None = None):
        self.blobs: dict[str, bytes] = dict(blobs or {})
        self.range_requests: list[tuple[str, int, int]] = []
        self.writes: list[str] = []

    def size(self, path: str) -> int:
        if path not in self.blobs:
            raise FileNotFoundError(path)
        return len(self.blobs[path])

    def read_range(self, path: str, start: int, length: int) -> bytes:
        self.range_requests.append((path, start, length))
        return self.blobs[path][start : start + length]

    def write(self, path: str, data: bytes) -> None:
        self.writes.append(path)
        self.blobs[path] = bytes(data)


class HttpTransport:
    """HTTP(S) ranged transport over stdlib urllib — a REAL network-backed
    transport for `http(s)://` BAM/CRAM/FASTA inputs (read-only), matching
    htslib's hfile_libcurl capability (reference: hts/extractor.h:53-121
    cloud URIs). Loopback-tested without egress: the test suite spins an
    in-process Range-serving httpd (tests/test_cloud_transport.py)."""

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout

    def size(self, path: str) -> int:
        import urllib.request

        req = urllib.request.Request(path, method="HEAD")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            cl = r.headers.get("Content-Length")
            if cl is None:
                raise OSError(f"no Content-Length from {path}")
            return int(cl)

    def read_range(self, path: str, start: int, length: int) -> bytes:
        import urllib.request

        req = urllib.request.Request(
            path, headers={"Range": f"bytes={start}-{start + length - 1}"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            data = r.read()
            status = r.status
        if status == 200 and start:
            # server ignored Range and returned the whole object
            data = data[start : start + length]
        return data[:length]

    def write(self, path: str, data: bytes) -> None:
        raise OSError("http transport is read-only; write VCF locally or "
                      "register an s3/gs transport")


def _auto_transport(scheme: str):
    if scheme in ("http", "https"):
        t = HttpTransport()
        _TRANSPORTS[scheme] = t
        return t
    return None


def open_remote(path: str, mode: str = "rb"):
    """Back-compat alias for hts_open restricted to cloud URIs."""
    if not is_cloud_uri(path):
        raise ValueError(f"not a cloud URI: {path!r}")
    return hts_open(path, mode)
