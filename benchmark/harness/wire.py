"""OTLP ExportTraceServiceRequest bodies, encoded in bulk with NumPy.

A body holds one ResourceSpans per service (``service.name`` on its
resource, as a collector's batch processor groups them), each with one
ScopeSpans of that service's spans. A span is written as

    trace_id (16 B) · span_id (8 B) · start and end (fixed64) ·
    status (code 0 or 2) · kind (SERVER) · name and fixed attributes ·
    the monitored attribute, if the span carries one

The first six fields have a fixed length, so every span's fixed part is
one row of a byte matrix; the name part comes from a table per
(service, operation) and the attribute part from a table per value.
A body is then one gather from these tables, through a list of
(offset, length) segments in output order.
"""

from __future__ import annotations

import numpy as np

_FIXED = 52  # bytes of the fixed-length span fields
_MIN_CONTENT = 128  # span content this long or longer has a 2-byte length


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_len(num: int, payload: bytes) -> bytes:
    return varint(num << 3 | 2) + varint(len(payload)) + payload


def key_value(key: str, value: str) -> bytes:
    """An attribute (KeyValue with a string AnyValue)."""
    return field_len(1, key.encode()) + field_len(2, field_len(1, value.encode()))


def _varints(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Varint bytes of each value below 2**28: uint8[n, 4] and lengths."""
    v = np.asarray(v, np.int64)
    if v.size and (v.min() < 0 or v.max() >= 1 << 28):
        raise ValueError("length outside the 4-byte varint range")
    n = 1 + (v >= 1 << 7) + (v >= 1 << 14) + (v >= 1 << 21)
    out = np.zeros((v.shape[0], 4), np.uint8)
    for k in range(4):
        more = n > k + 1
        out[:, k] = ((v >> (7 * k)) & 0x7F) | np.where(more, 0x80, 0)
    return out, n


def _gather(src: np.ndarray, start: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Concatenate ``src[start[i] : start[i] + length[i]]`` over i: the
    source index steps by one inside a segment and jumps between them."""
    keep = length > 0
    start, length = start[keep].astype(np.int64), length[keep].astype(np.int64)
    out_start = np.cumsum(length) - length
    dtype = np.int32 if src.shape[0] < 2**31 else np.int64
    step = np.ones(int(length.sum()), dtype)
    step[0] = start[0]
    step[out_start[1:]] = start[1:] - (start[:-1] + length[:-1] - 1)
    return src[np.cumsum(step, dtype=dtype)]


class Encoder:
    """Encodes bodies of spans drawn from one corpus.

    ``services`` are the service names; ``ops[s]`` the operation names
    of service ``s``; ``attrs`` the (key, value) pairs a span's
    monitored attribute is drawn from.
    """

    def __init__(self, services, ops, attrs):
        # The tags of a ResourceSpans (0x0A) and of its ScopeSpans (0x12),
        # then the ScopeSpans' scope field.
        const = b"\x0a\x12" + field_len(1, field_len(1, b"bench"))
        self._scope_len = len(const) - 2
        res = [field_len(1, field_len(1, key_value("service.name", s))) for s in services]
        names = []
        for si, svc_ops in enumerate(ops):
            for op in svc_ops:
                part = (field_len(5, op.encode()) + key_value_field("rpc.system", "grpc")
                        + key_value_field("rpc.service", f"oteldemo.{services[si]}")
                        + key_value_field("rpc.method", op))
                while len(part) + _FIXED < _MIN_CONTENT:
                    part += key_value_field("net.peer.port", "8080")
                names.append(part)
        n_attrs = len(attrs)
        attrs = [key_value_field(k, v) for k, v in attrs] + [b""]
        self.op_base = np.cumsum([0] + [len(o) for o in ops])[:-1].astype(np.int64)
        tables = [const, b"".join(res), b"".join(names), b"".join(attrs)]
        base = np.cumsum([0] + [len(t) for t in tables])
        self.src_tables = np.frombuffer(b"".join(tables), np.uint8)
        self.res_off = base[1] + np.cumsum([0] + [len(r) for r in res])[:-1]
        self.res_len = np.array([len(r) for r in res], np.int64)
        self.name_off = base[2] + np.cumsum([0] + [len(n) for n in names])[:-1]
        self.name_len = np.array([len(n) for n in names], np.int64)
        self.attr_off = base[3] + np.cumsum([0] + [len(a) for a in attrs])[:-1]
        self.attr_len = np.array([len(a) for a in attrs], np.int64)
        self.n_attrs = n_attrs

    def encode(self, corpus: dict, bodies: list[np.ndarray]) -> list[bytes]:
        """One body per index array (corpus rows in document order, each
        service's rows contiguous)."""
        out: list[bytes] = []
        chunk: list[np.ndarray] = []
        rows = 0
        for b in bodies:
            chunk.append(b)
            rows += len(b)
            if rows >= 65536:
                out += self._encode_chunk(corpus, chunk)
                chunk, rows = [], 0
        if chunk:
            out += self._encode_chunk(corpus, chunk)
        return out

    def _encode_chunk(self, c: dict, bodies: list[np.ndarray]) -> list[bytes]:
        idx = np.concatenate(bodies)
        n = idx.shape[0]
        svc = c["svc"][idx].astype(np.int64)
        body_of = np.repeat(np.arange(len(bodies)), [len(b) for b in bodies])
        # Groups: runs of one service within one body.
        new = np.r_[True, (svc[1:] != svc[:-1]) | (body_of[1:] != body_of[:-1])]
        group = np.cumsum(new) - 1
        g_first = np.nonzero(new)[0]
        g_svc, g_body = svc[g_first], body_of[g_first]
        n_groups = g_first.shape[0]

        name_id = self.op_base[svc] + c["op"][idx]
        attr = np.where(c["attr"][idx] < 0, self.n_attrs, c["attr"][idx])
        content = _FIXED + self.name_len[name_id] + self.attr_len[attr]
        if content.max(initial=0) >= 1 << 14:
            raise ValueError("span longer than a 2-byte length")
        var = np.zeros((n, 3 + _FIXED), np.uint8)
        var[:, 0] = 0x12
        var[:, 1] = (content & 0x7F) | 0x80
        var[:, 2] = content >> 7
        put = _Columns(var, 3)
        put.tag(0x0A, 16)
        put.u64(c["trace_lo"][idx])
        put.u64(c["trace_hi"][idx])
        put.tag(0x12, 8)
        put.u64(c["span_id"][idx])
        start = c["start_ns"][idx].astype(np.uint64)
        put.raw(np.full(n, 0x39, np.uint8))
        put.u64(start)
        put.raw(np.full(n, 0x41, np.uint8))
        put.u64(start + c["dur_us"][idx].astype(np.uint64) * np.uint64(1000))
        put.tag(0x7A, 2)
        put.raw(np.full(n, 0x18, np.uint8))
        put.raw(np.where(c["err"][idx], 2, 0).astype(np.uint8))
        put.raw(np.full(n, 0x30, np.uint8))
        put.raw(np.full(n, 2, np.uint8))

        span_bytes = 3 + content
        ss_len = self._scope_len + np.bincount(group, weights=span_bytes, minlength=n_groups).astype(np.int64)
        v_ss, l_ss = _varints(ss_len)
        rs_len = self.res_len[g_svc] + 1 + l_ss + ss_len
        v_rs, l_rs = _varints(rs_len)
        piece = 1 + l_rs + rs_len
        body_len = np.bincount(g_body, weights=piece, minlength=len(bodies)).astype(np.int64)

        base_vrs = self.src_tables.shape[0]
        base_vss = base_vrs + 4 * n_groups
        base_var = base_vss + 4 * n_groups
        src = np.concatenate([self.src_tables, v_rs.reshape(-1), v_ss.reshape(-1), var.reshape(-1)])
        gi = np.arange(n_groups)
        si = np.arange(n)
        n_seg = 6 * n_groups + 3 * n
        seg_start = np.empty(n_seg, np.int64)
        seg_len = np.empty(n_seg, np.int64)
        g_pos = 6 * gi + 3 * g_first
        for j, (s0, ln) in enumerate((
            (np.zeros(n_groups, np.int64), np.ones(n_groups, np.int64)),
            (base_vrs + 4 * gi, l_rs),
            (self.res_off[g_svc], self.res_len[g_svc]),
            (np.ones(n_groups, np.int64), np.ones(n_groups, np.int64)),
            (base_vss + 4 * gi, l_ss),
            (np.full(n_groups, 2, np.int64), np.full(n_groups, self._scope_len, np.int64)),
        )):
            seg_start[g_pos + j] = s0
            seg_len[g_pos + j] = ln
        s_pos = 6 * (group + 1) + 3 * si
        for j, (s0, ln) in enumerate((
            (base_var + (3 + _FIXED) * si, np.full(n, 3 + _FIXED, np.int64)),
            (self.name_off[name_id], self.name_len[name_id]),
            (self.attr_off[attr], self.attr_len[attr]),
        )):
            seg_start[s_pos + j] = s0
            seg_len[s_pos + j] = ln
        flat = _gather(src, seg_start, seg_len)
        ends = np.cumsum(body_len)
        return [flat[e - ln:e].tobytes() for e, ln in zip(ends, body_len)]


def key_value_field(key: str, value: str) -> bytes:
    """A span's attribute field (Span.attributes, field 9)."""
    return field_len(9, key_value(key, value))


class _Columns:
    """Writes fixed-width fields left to right into a byte matrix."""

    def __init__(self, mat: np.ndarray, col: int):
        self.mat = mat
        self.col = col

    def raw(self, col: np.ndarray) -> None:
        self.mat[:, self.col] = col
        self.col += 1

    def tag(self, tag: int, length: int) -> None:
        self.mat[:, self.col] = tag
        self.mat[:, self.col + 1] = length
        self.col += 2

    def u64(self, v: np.ndarray) -> None:
        self.mat[:, self.col:self.col + 8] = np.ascontiguousarray(v, "<u8").view(np.uint8).reshape(-1, 8)
        self.col += 8
