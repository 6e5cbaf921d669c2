"""The KV-slab wire formats of the disaggregated prefill -> decode handoff (``paddle_tpu/generation/handoff.py``).

A prefill-tier backend runs the bucketed forward and ships the slot's KV
planes to a decode-tier backend (``POST /generate_kv``, octet-stream body).
The slab describes itself and is checked on arrival:

``PTKV | version u16 | header_len u32 | header JSON | payload | crc32``

- the header names every plane's shape and dtype, the true prompt length,
  the first sampled token and a ``meta`` dict (the request's generation
  parameters and the cache geometry; for a speculative decode tier the
  prompt tokens too, since the slab holds the target's cache only);
- the payload is the planes' bytes back to back, C-order;
- the trailing CRC32 covers header and payload, so a truncated or corrupted
  body is refused at unpack (:class:`HandoffError`, HTTP 400), never half
  installed into a decode slot.

An f32 slab carries 2 planes (k, v, each ``[L, H, C, D]``), an int8 slab 4
(int8 k, v and the f32 scale planes ``[L, H, C]``). The page-granular
sibling, magic ``PTKP``, has the same framing; its payload is a list of
fixed-size pages, each described and SHA-256'd on its own, and a page the
receiver already holds (``GenerationEngine.known_page_hashes``) ships
header-only (``present: false``) and is mapped copy-on-write out of the
receiver's prefix index.

The framing is byte for byte the JAX package's (the same header JSON with
``separators=(",", ":")``, C-order payload, CRC32 trailer), so slabs cross
between the two packages in both directions. Planes cross the boundary as
numpy arrays: the engine copies them off the card through a pinned buffer
before packing.
"""
from __future__ import annotations

import hashlib
import json
import struct
import zlib
from typing import NamedTuple

import numpy as np

from ..errors import InvalidArgumentError

__all__ = ["HandoffError", "pack_kv_slab", "unpack_kv_slab",
           "PageSlab", "pack_kv_pages", "unpack_kv_pages",
           "HANDOFF_CONTENT_TYPE", "HANDOFF_PAGED_CONTENT_TYPE"]

_MAGIC = b"PTKV"
_MAGIC_PAGED = b"PTKP"
_VERSION = 1
_HEAD = struct.Struct(">4sHI")  # magic, version, header_len
_CRC = struct.Struct(">I")
_MAX_REFCOUNT = 1 << 31

#: the /generate_kv request body content type
HANDOFF_CONTENT_TYPE = "application/x-ptpu-kv-slab"


class HandoffError(InvalidArgumentError):
    """The slab failed validation (truncated, corrupt, or the wrong
    geometry for the receiving engine). Maps to HTTP 400 — the payload
    is unusable, retrying elsewhere cannot help."""


def pack_kv_slab(planes, length, first_token, meta=None) -> bytes:
    """Serialize one slot's KV planes plus riding metadata.

    ``planes`` are the window-width per-slot arrays from
    ``GenerationEngine.prefill_export`` (numpy, or tensors on the host; 2
    for f32, 4 for int8). ``length`` is the true prompt length, ``first_token``
    the prefill tier's sampled token. ``meta`` is an arbitrary
    JSON-able dict (generation params, cache geometry).
    """
    arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes]
    header = {
        "planes": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in arrs],
        "length": int(length),
        "first_token": int(first_token),
        "meta": dict(meta or {}),
    }
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload = b"".join(a.tobytes() for a in arrs)
    body = _HEAD.pack(_MAGIC, _VERSION, len(hbytes)) + hbytes + payload
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def unpack_kv_slab(data: bytes):
    """Parse and VALIDATE a slab: returns ``(planes, length,
    first_token, meta)`` with planes as numpy arrays. Raises
    :class:`HandoffError` on any structural problem — magic, version,
    size arithmetic, or CRC mismatch (truncation and corruption both
    land here)."""
    if len(data) < _HEAD.size + _CRC.size:
        raise HandoffError(
            f"KV slab truncated: {len(data)} bytes is smaller than the "
            "fixed framing")
    magic, version, hlen = _HEAD.unpack_from(data, 0)
    if magic != _MAGIC:
        raise HandoffError("not a KV slab (bad magic)")
    if version != _VERSION:
        raise HandoffError(
            f"KV slab version {version} unsupported (this build speaks "
            f"{_VERSION})")
    body, crc_bytes = data[:-_CRC.size], data[-_CRC.size:]
    (crc,) = _CRC.unpack(crc_bytes)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise HandoffError(
            "KV slab checksum mismatch (truncated or corrupted payload)")
    if _HEAD.size + hlen > len(body):
        raise HandoffError("KV slab header overruns the payload")
    try:
        header = json.loads(body[_HEAD.size:_HEAD.size + hlen])
        specs = header["planes"]
        length = int(header["length"])
        first_token = int(header["first_token"])
        meta = dict(header.get("meta") or {})
    except (ValueError, KeyError, TypeError) as e:
        raise HandoffError(f"KV slab header malformed: {e}") from None
    off = _HEAD.size + hlen
    planes = []
    for spec in specs:
        try:
            shape = tuple(int(d) for d in spec["shape"])
            dtype = np.dtype(spec["dtype"])
        except (ValueError, KeyError, TypeError) as e:
            raise HandoffError(
                f"KV slab plane spec malformed: {e}") from None
        if dtype.kind not in "fiu" or any(d < 0 for d in shape):
            # only numeric planes can come off a wire buffer — an
            # "object" dtype (CRC-valid header, hostile or buggy
            # sender) would crash frombuffer with a raw ValueError
            # instead of the 400 this module promises
            raise HandoffError(
                f"KV slab plane spec invalid: dtype {dtype}, "
                f"shape {shape}")
        n = int(np.prod(shape)) * dtype.itemsize
        if off + n > len(body):
            raise HandoffError(
                "KV slab payload shorter than its plane specs")
        try:
            planes.append(np.frombuffer(body, dtype=dtype, count=int(
                np.prod(shape)), offset=off).reshape(shape))
        except (ValueError, TypeError) as e:
            raise HandoffError(
                f"KV slab plane unreadable: {e}") from None
        off += n
    if off != len(body):
        raise HandoffError(
            f"KV slab carries {len(body) - off} trailing bytes beyond "
            "its plane specs")
    return tuple(planes), length, first_token, meta


# -- page-granular format (PTKP) ----------------------------------------------

#: the /generate_kv request body content type for page-granular slabs
HANDOFF_PAGED_CONTENT_TYPE = "application/x-ptpu-kv-pages"


class PageSlab(NamedTuple):
    """A parsed page-granular handoff: ``pages`` is a list of dicts
    ``{"id", "hash", "planes"}`` in page order — ``planes`` is the
    page's per-plane array tuple, or ``None`` for a page the sender
    knows the receiver already holds (resolved through its prefix
    index); ``hash`` is the page's CHAIN hash (None for the partial
    tail page, which can never be shared)."""

    pages: list
    length: int
    first_token: int
    page_size: int
    meta: dict


def pack_kv_pages(pages, length, first_token, page_size,
                  meta=None) -> bytes:
    """Serialize a page-granular handoff.

    ``pages`` come from ``GenerationEngine.prefill_export_pages``: a
    list of ``{"id", "hash", "planes"}`` dicts in page order, where
    ``planes is None`` marks a page the receiver already holds (it is
    shipped header-only). Each present page's payload is individually
    SHA-256'd so a flipped bit names the page it corrupted; an optional
    ``"refcount"`` per page (the sender's share count, advisory for
    cache peers) is range-checked on both ends.
    """
    specs, chunks = [], []
    for page in pages:
        planes = page.get("planes")
        rc = int(page.get("refcount", 1))
        if not 0 <= rc < _MAX_REFCOUNT:
            raise HandoffError(
                f"page {page.get('id')} refcount {rc} outside "
                f"[0, {_MAX_REFCOUNT})")
        entry = {"id": int(page["id"]), "hash": page.get("hash"),
                 "refcount": rc}
        if planes is None:
            entry["present"] = False
            entry["planes"] = None
            entry["payload_sha"] = None
        else:
            arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes]
            raw = b"".join(a.tobytes() for a in arrs)
            entry["present"] = True
            entry["planes"] = [
                {"shape": list(a.shape), "dtype": str(a.dtype)}
                for a in arrs]
            entry["payload_sha"] = hashlib.sha256(raw).hexdigest()
            chunks.append(raw)
        specs.append(entry)
    header = {
        "page_size": int(page_size),
        "length": int(length),
        "first_token": int(first_token),
        "pages": specs,
        "meta": dict(meta or {}),
    }
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = (_HEAD.pack(_MAGIC_PAGED, _VERSION, len(hbytes)) + hbytes
            + b"".join(chunks))
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def unpack_kv_pages(data: bytes) -> PageSlab:
    """Parse and VALIDATE a page-granular slab. Every structural
    problem raises :class:`HandoffError` (-> HTTP 400) BEFORE anything
    could land in a decode slot: bad magic/version/CRC, a page list
    that does not cover ``length`` (truncated page list), duplicate
    page ids, a refcount outside ``[0, 2^31)`` (overflow), or a page
    whose payload bytes do not hash to its declared ``payload_sha``
    (bit-flip localized to the page)."""
    if len(data) < _HEAD.size + _CRC.size:
        raise HandoffError(
            f"KV page slab truncated: {len(data)} bytes is smaller "
            "than the fixed framing")
    magic, version, hlen = _HEAD.unpack_from(data, 0)
    if magic != _MAGIC_PAGED:
        raise HandoffError("not a KV page slab (bad magic)")
    if version != _VERSION:
        raise HandoffError(
            f"KV page slab version {version} unsupported (this build "
            f"speaks {_VERSION})")
    body, crc_bytes = data[:-_CRC.size], data[-_CRC.size:]
    (crc,) = _CRC.unpack(crc_bytes)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise HandoffError(
            "KV page slab checksum mismatch (truncated or corrupted "
            "payload)")
    if _HEAD.size + hlen > len(body):
        raise HandoffError("KV page slab header overruns the payload")
    try:
        header = json.loads(body[_HEAD.size:_HEAD.size + hlen])
        page_size = int(header["page_size"])
        length = int(header["length"])
        first_token = int(header["first_token"])
        specs = list(header["pages"])
        meta = dict(header.get("meta") or {})
    except (ValueError, KeyError, TypeError) as e:
        raise HandoffError(
            f"KV page slab header malformed: {e}") from None
    if page_size < 1 or length < 1:
        raise HandoffError(
            f"KV page slab geometry invalid: page_size {page_size}, "
            f"length {length}")
    npages = -(-length // page_size)
    if len(specs) != npages:
        raise HandoffError(
            f"KV page slab page list truncated: {len(specs)} pages "
            f"cannot cover length {length} at page size {page_size} "
            f"({npages} needed)")
    ids = [s.get("id") for s in specs]
    if len(set(ids)) != len(ids):
        raise HandoffError("KV page slab carries duplicate page ids")
    off = _HEAD.size + hlen
    pages = []
    for spec in specs:
        try:
            pid = int(spec["id"])
            present = bool(spec["present"])
            rc = int(spec.get("refcount", 1))
            page_hash = spec.get("hash")
        except (ValueError, KeyError, TypeError) as e:
            raise HandoffError(
                f"KV page slab page spec malformed: {e}") from None
        if not 0 <= rc < _MAX_REFCOUNT:
            raise HandoffError(
                f"page {pid} refcount {rc} overflows [0, "
                f"{_MAX_REFCOUNT})")
        if not present:
            if page_hash is None:
                raise HandoffError(
                    f"page {pid} is absent from the payload but names "
                    "no hash to resolve it by")
            pages.append({"id": pid, "hash": page_hash, "planes": None})
            continue
        plane_specs = spec.get("planes")
        if not plane_specs:
            raise HandoffError(
                f"page {pid} is marked present but names no planes")
        start = off
        planes = []
        for pspec in plane_specs:
            try:
                shape = tuple(int(d) for d in pspec["shape"])
                dtype = np.dtype(pspec["dtype"])
            except (ValueError, KeyError, TypeError) as e:
                raise HandoffError(
                    f"page {pid} plane spec malformed: {e}") from None
            if dtype.kind not in "fiu" or any(d < 0 for d in shape):
                raise HandoffError(
                    f"page {pid} plane spec invalid: dtype {dtype}, "
                    f"shape {shape}")
            n = int(np.prod(shape)) * dtype.itemsize
            if off + n > len(body):
                raise HandoffError(
                    f"KV page slab payload ends inside page {pid}")
            planes.append(np.frombuffer(
                body, dtype=dtype, count=int(np.prod(shape)),
                offset=off).reshape(shape))
            off += n
        want = spec.get("payload_sha")
        got = hashlib.sha256(body[start:off]).hexdigest()
        if want != got:
            raise HandoffError(
                f"page {pid} payload hash mismatch (corrupted in "
                "flight); refusing the whole slab")
        pages.append({"id": pid, "hash": page_hash,
                      "planes": tuple(planes)})
    if off != len(body):
        raise HandoffError(
            f"KV page slab carries {len(body) - off} trailing bytes "
            "beyond its page specs")
    return PageSlab(pages, length, first_token, page_size, meta)
