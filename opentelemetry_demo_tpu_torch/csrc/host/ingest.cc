// Native ingest: protobuf wire → columnar span tensors, C ABI.
//
// The host side of the ≥200k spans/sec target (SURVEY.md §7 hard part
// (a)): protobuf decode and attribute hashing must not be a per-record
// Python loop. This library decodes the two ingest seams directly into
// columnar arrays the tensorizer turns into device batches.
//
// **Two-pass structural decode** (the r15 decode-wall rework,
// simdjson-style): pass 1 (`scan_request`) is a boundary sweep that
// validates the structural levels — top-level fields, ResourceSpans
// including the resource's KeyValues, ScopeSpans, span headers — and
// records one (ptr, len, svc) entry per span WITHOUT parsing span
// interiors (their bytes are skipped by length). Pass 2
// (`extract_span`) consumes that structural index and extracts the
// columns, one independent span at a time, with no re-parsing of the
// framing. The split buys three things:
//
//   - exact capacity up front: pass 1 knows the span/resource/name
//     totals before a single column row is written, so -2/-3 are
//     decided once instead of mid-parse;
//   - **intra-call sharding**: `otd_decode_otlp_many` splits the
//     combined span index across `n_threads` worker threads at span-
//     record boundaries (including MID-payload — one oversized OTLP
//     export no longer serializes on one core), each thread writing a
//     disjoint row range of the shared output columns;
//   - attributable phases: the call reports scan vs extract wall time
//     (`scan_s` / `extract_s`), which runtime/ingest_pool.py feeds to
//     the anomaly_phase_seconds{phase=scan|extract} histograms.
//
// Verdict parity with the single-pass decoder is by construction: the
// two passes together check exactly the constraint set the old
// interleaved walk checked (pass 1 the framing, pass 2 the span
// interiors), and a payload is malformed iff either pass says so —
// order of discovery never changes a per-payload verdict. A pass-2
// failure marks its payload bad; a single-threaded epilogue compacts
// the bad payload's rows/services back out (append-only writes make
// the compaction a handful of memmoves), so batchmates keep their
// rows and `payload_rows` keeps the old -1-per-bad-payload contract.
//
// The decoded seams:
//
//   - OTLP ExportTraceServiceRequest (the collector-export seam; field
//     numbers per opentelemetry-proto trace/v1, mirrored from
//     runtime/otlp.py which mirrors the reference collector config
//     the demo's src/otel-collector/otelcol-config.yml:120-123).
//   - OrderResult from the Kafka `orders` topic (field numbers per
//     the demo's pb/demo.proto:203-214, same contract as the
//     reference consumers Consumer.cs:59-70 / main.kt:64).
//
// Parity contract with runtime/wire.py + runtime/otlp.py +
// runtime/kafka_orders.py (enforced by tests/test_native_ingest.py):
// identical columns on well-formed payloads AND identical error
// verdicts on malformed ones — the HTTP receiver answers 400 where the
// Python path would, never 200-and-drop. The Python decoders' field
// semantics fall into a few categories, modelled explicitly below:
//
//   submessage-list  — every occurrence descended, any non-LEN value
//                      is an error (Python: scan_fields(int) raises).
//   submessage-first — first occurrence claims the slot; LEN descends,
//                      numeric 0 is "absent" (falsy), numeric nonzero
//                      is an error (truthy int hits scan_fields).
//   bytes-first      — first occurrence claims the slot; LEN is the
//                      value, numeric 0 falls to the default, numeric
//                      nonzero is an error (int.decode()).
//   numeric-first    — first occurrence claims the slot; any numeric
//                      wire type is the value (wire.py decodes varint/
//                      fixed alike), empty LEN is falsy-skip, nonempty
//                      LEN is an error (int(bytes) raises).
//
// Strings are hashed with zlib-compatible CRC32 exactly as the Python
// tensorizer does.
//
// Build: g++ -O3 -shared -fPIC (no dependencies). Loaded via ctypes by
// opentelemetry_demo_tpu/runtime/native.py.

#include <atomic>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32
// IEEE CRC-32 (zlib/zip polynomial 0xEDB88320), table-driven; must
// match Python's zlib.crc32 bit-for-bit (tensorize.py attr keys).
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const Crc32Table kCrc;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = kCrc.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// --------------------------------------------------------------- crc32c
// CRC-32C (Castagnoli polynomial 0x82F63B78, reflected) — the frame
// checksum (runtime/frame.py); slicing-by-8 so verify runs at memory
// bandwidth rather than per-byte table speed. Must match frame.py's
// portable _py_crc32c bit-for-bit (pinned by tests/test_frame.py).
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = t[0][t[s - 1][i] & 0xFF] ^ (t[s - 1][i] >> 8);
  }
};
const Crc32cTable kCrc32c;

uint32_t crc32c_sw(uint32_t seed, const uint8_t* p, size_t n) {
  uint32_t c = ~seed;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = kCrc32c.t[7][c & 0xFF] ^ kCrc32c.t[6][(c >> 8) & 0xFF] ^
        kCrc32c.t[5][(c >> 16) & 0xFF] ^ kCrc32c.t[4][c >> 24] ^
        kCrc32c.t[3][hi & 0xFF] ^ kCrc32c.t[2][(hi >> 8) & 0xFF] ^
        kCrc32c.t[1][(hi >> 16) & 0xFF] ^ kCrc32c.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = kCrc32c.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

// CRC-32C in hardware where the ISA offers it: the Castagnoli
// polynomial IS x86 SSE4.2's crc32 instruction (and AArch64's CRC32C
// extension), so the hardware path is bit-identical to the sliced
// table walk by definition of the instruction — the ingest-hop verify,
// the parked-scratch recycle re-check and every frame trailer run at
// instruction speed (~3 bytes/cycle) instead of table speed. Runtime-
// detected once; the portable slicing-by-8 path stays the fallback
// (and the only path on other ISAs).
#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t seed,
                                                     const uint8_t* p,
                                                     size_t n) {
  uint32_t c = ~seed;
#if defined(__x86_64__)
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c64 = __builtin_ia32_crc32di(c64, v);
    p += 8;
    n -= 8;
  }
  c = uint32_t(c64);
#endif
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return ~c;
}
bool crc32c_hw_available() {
  return __builtin_cpu_supports("sse4.2");
}
#else
uint32_t crc32c_hw(uint32_t seed, const uint8_t* p, size_t n) {
  return crc32c_sw(seed, p, n);
}
bool crc32c_hw_available() { return false; }
#endif

const bool kCrc32cHw = crc32c_hw_available();

uint32_t crc32c_update(uint32_t seed, const uint8_t* p, size_t n) {
  return kCrc32cHw ? crc32c_hw(seed, p, n) : crc32c_sw(seed, p, n);
}

// ------------------------------------------------------------ wire scan
constexpr int kVarint = 0;
constexpr int kFixed64 = 1;
constexpr int kLen = 2;
constexpr int kFixed32 = 5;

struct Slice {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool done() const { return pos >= n; }
};

// Decode one base-128 varint; false on truncation/overlength (parity
// with wire.read_varint's 64-bit cap).
bool read_varint(Slice& s, uint64_t& out) {
  uint64_t result = 0;
  int shift = 0;
  while (true) {
    if (s.pos >= s.n) return false;
    uint8_t b = s.p[s.pos++];
    result |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
}

// One field header + payload. For LEN fields `val`/`len` hold the bytes;
// for varint/fixed the numeric value lands in `num`. Returns false on
// malformed input (the caller surfaces it as a WireError analogue).
struct Field {
  uint32_t no;
  int wt;
  uint64_t num;
  const uint8_t* val;
  size_t len;
};

bool next_field(Slice& s, Field& f) {
  uint64_t tag;
  if (!read_varint(s, tag)) return false;
  f.no = uint32_t(tag >> 3);
  f.wt = int(tag & 0x7);
  if (f.no == 0) return false;
  switch (f.wt) {
    case kVarint:
      return read_varint(s, f.num);
    case kFixed64:
      if (s.pos + 8 > s.n) return false;
      std::memcpy(&f.num, s.p + s.pos, 8);  // little-endian hosts only
      s.pos += 8;
      return true;
    case kFixed32: {
      if (s.pos + 4 > s.n) return false;
      uint32_t v;
      std::memcpy(&v, s.p + s.pos, 4);
      s.pos += 4;
      f.num = v;
      return true;
    }
    case kLen: {
      uint64_t ln;
      if (!read_varint(s, ln)) return false;
      if (ln > s.n - s.pos) return false;
      f.val = s.p + s.pos;
      f.len = size_t(ln);
      s.pos += size_t(ln);
      return true;
    }
    default:
      return false;  // SGROUP/EGROUP etc: wire.py raises on these
  }
}

bool numeric(const Field& f) {
  return f.wt == kVarint || f.wt == kFixed64 || f.wt == kFixed32;
}

struct Str {
  const uint8_t* p = nullptr;
  size_t n = 0;
  bool set = false;
};

// --- the Python decoders' field-slot semantics (see file header) -----

// submessage-list: every occurrence must be LEN. ok=false ⇒ caller
// errors; descend=true ⇒ this occurrence is a submessage to parse.
bool sub_list(const Field& f, bool& descend) {
  descend = (f.wt == kLen);
  return f.wt == kLen;
}

// submessage-first: `claimed` is the slot. Sets descend for a LEN first
// occurrence; numeric 0 claims the slot as "absent"; numeric nonzero
// is an error.
bool sub_first(const Field& f, bool& claimed, bool& descend) {
  descend = false;
  if (claimed) return true;
  claimed = true;
  if (f.wt == kLen) {
    descend = true;
    return true;
  }
  return numeric(f) && f.num == 0;
}

// bytes-first: LEN claims with the value; numeric 0 claims with the
// default; numeric nonzero errors.
bool bytes_first(const Field& f, Str& out) {
  if (out.set) return true;
  if (f.wt == kLen) {
    out.p = f.val;
    out.n = f.len;
    out.set = true;
    return true;
  }
  if (numeric(f) && f.num == 0) {
    out.set = true;  // claimed, stays at default (empty)
    return true;
  }
  return false;
}

// numeric-first: numeric claims with the value; nonempty LEN errors
// (int(bytes) of non-digits raises). Empty LEN depends on the Python
// call-site shape: `int(first(...) or 0)` treats b"" as falsy → default
// (empty_len_ok), while bare `float(first(...))` raises on b"" —
// callers pass empty_len_ok=false to model the latter.
bool numeric_first(const Field& f, bool& claimed, uint64_t& out,
                   bool empty_len_ok = true) {
  if (claimed) return true;
  if (numeric(f)) {
    claimed = true;
    out = f.num;
    return true;
  }
  if (empty_len_ok && f.wt == kLen && f.len == 0) {
    claimed = true;
    return true;
  }
  return false;
}

bool str_eq(const Str& s, const char* lit) {
  size_t n = std::strlen(lit);
  return s.set && s.n == n && std::memcmp(s.p, lit, n) == 0;
}

// Length-precomputed variant for the monitored-key compares in the
// span hot loop (strlen per attribute per key was measurable at the
// flush scale the pool runs).
inline bool str_eq_n(const Str& s, const char* lit, size_t n) {
  return s.set && s.n == n && std::memcmp(s.p, lit, n) == 0;
}

// AnyValue{string_value=1}: first occurrence of a LEN field 1 is the
// string; any other type/field is ignored (otlp._anyvalue_str returns
// None for non-string values, raising nothing).
bool anyvalue_str(const uint8_t* p, size_t n, Str& out) {
  Slice s{p, n};
  Field f;
  while (!s.done()) {
    if (!next_field(s, f)) return false;
    if (f.no == 1 && f.wt == kLen && !out.set) {
      out.p = f.val;
      out.n = f.len;
      out.set = true;
    }
  }
  return true;
}

// KeyValue{key=1, value=2}. Mirrors otlp._attrs_to_dict exactly: the
// pair only materialises when the key is truthy, the value is LEN, and
// the AnyValue holds a string; a truthy *numeric* key is an error only
// in that same case (Python reaches key.decode() only then).
bool keyvalue(const uint8_t* p, size_t n, Str& key, Str& val) {
  Slice s{p, n};
  Field f;
  Str raw_val;
  bool key_numeric_bad = false;
  bool key_claimed = false;
  while (!s.done()) {
    if (!next_field(s, f)) return false;
    if (f.no == 1 && !key_claimed) {
      key_claimed = true;
      if (f.wt == kLen) {
        key.p = f.val;
        key.n = f.len;
        key.set = true;
      } else if (numeric(f) && f.num != 0) {
        key_numeric_bad = true;  // only fatal if a string value exists
      }
    } else if (f.no == 2 && f.wt == kLen && !raw_val.set) {
      raw_val.p = f.val;
      raw_val.n = f.len;
      raw_val.set = true;
    }
  }
  if (raw_val.set && !anyvalue_str(raw_val.p, raw_val.n, val)) return false;
  if (val.set && key_numeric_bad) return false;  // int.decode() analogue
  if (!(key.set && key.n > 0)) val.set = false;  // falsy key: pair skipped
  return true;
}

// First 8 bytes little-endian, zero-padded — matches
// tensorize._pack's `bytes(trace_id[:8]).ljust(8, b"\0")`.
uint64_t key8(const uint8_t* p, size_t n) {
  uint64_t v = 0;
  std::memcpy(&v, p, n < 8 ? n : 8);
  return v;
}

constexpr int kMaxAttrKeys = 16;

}  // namespace

namespace {

// ---------------------------------------------------------- pass 1: scan
// One structural-index entry per span record (the pass-1 product).
struct SpanRef {
  const uint8_t* p;  // span submessage bytes
  uint32_t len;
  int32_t svc;      // batch-wide resource-spans entry index
  int32_t payload;  // payload index within the batch (verdict mapping)
};

// Structural sweep of one ExportTraceServiceRequest: validates the
// framing levels (top-level fields, ResourceSpans incl. the resource's
// KeyValues, ScopeSpans, span headers), APPENDS service names to the
// shared name buffer, and emits one boundary record per span WITHOUT
// descending into span interiors — pass 2's job. The sweep is branch-
// light on purpose: span bodies (the bulk of the bytes) are skipped by
// their LEN header, so scan throughput is set by varint-walk speed,
// not field semantics. Returns the new total span count or a negative
// error code (-1 malformed framing, -2 span capacity, -3 name/entry
// capacity).
template <typename EmitSpan>
int scan_request(const uint8_t* buf, size_t len, int payload_idx,  //
                 char* svc_buf, size_t svc_buf_cap,                //
                 int32_t* svc_len, int rs_cap,                     //
                 int* n_svc_io, size_t* svc_pos_io,                //
                 int n_spans, int span_cap, EmitSpan&& emit) {
  int n_svc = *n_svc_io;
  size_t svc_pos = *svc_pos_io;
  Slice top{buf, len};
  Field rs_f;
  bool descend;
  while (!top.done()) {
    if (!next_field(top, rs_f)) return -1;
    if (rs_f.no != 1) continue;  // unknown top-level fields: skipped
    if (!sub_list(rs_f, descend)) return -1;

    // ResourceSpans{resource=1 (first), scope_spans=2 (repeated)}.
    // Sweep A: the resource can appear after scope_spans on the wire;
    // the Python decoder's two-phase scan is order-independent, so
    // resolve the service name before emitting this block's spans.
    Str svc_name;
    bool have_name = false;
    bool resource_claimed = false;
    Slice rs{rs_f.val, rs_f.len};
    Field f;
    while (!rs.done()) {
      if (!next_field(rs, f)) return -1;
      if (f.no == 1) {
        if (!sub_first(f, resource_claimed, descend)) return -1;
        if (!descend) continue;
        Slice res{f.val, f.len};
        Field rf;
        while (!res.done()) {
          if (!next_field(res, rf)) return -1;
          if (rf.no == 1) {  // repeated KeyValue (submessage-list)
            if (!sub_list(rf, descend)) return -1;
            Str key, val;
            if (!keyvalue(rf.val, rf.len, key, val)) return -1;
            // Last occurrence wins (dict-assignment semantics).
            if (val.set && str_eq(key, "service.name")) {
              svc_name = val;
              have_name = true;
            }
          }
        }
      }
    }
    if (n_svc >= rs_cap) return -3;
    if (svc_pos + svc_name.n > svc_buf_cap) return -3;
    if (svc_name.n) std::memcpy(svc_buf + svc_pos, svc_name.p, svc_name.n);
    svc_pos += svc_name.n;
    svc_len[n_svc++] = have_name ? int32_t(svc_name.n) : -1;

    // Sweep B: record span-record boundaries (no interior parse).
    rs = Slice{rs_f.val, rs_f.len};
    while (!rs.done()) {
      if (!next_field(rs, f)) return -1;
      if (f.no != 2) continue;  // ScopeSpans (submessage-list)
      if (!sub_list(f, descend)) return -1;
      Slice ss{f.val, f.len};
      Field sf;
      while (!ss.done()) {
        if (!next_field(ss, sf)) return -1;
        if (sf.no != 2) continue;  // Span (submessage-list)
        if (!sub_list(sf, descend)) return -1;
        if (n_spans >= span_cap) return -2;
        emit(sf.val, sf.len, n_svc - 1, payload_idx, n_spans);
        ++n_spans;
      }
    }
  }
  *n_svc_io = n_svc;
  *svc_pos_io = svc_pos;
  return n_spans;
}

// ------------------------------------------------------- pass 2: extract
// Extract ONE pass-1 span record into output row `r`. Field slot
// semantics are identical to the retired single-pass walk (the file
// header's four categories); rows are independent, which is what makes
// the extraction shardable across threads. Returns false on a
// malformed span interior (the caller maps it to the owning payload's
// -1 verdict).
bool extract_span(const uint8_t* p, size_t n, int32_t svc, int r,  //
                  const char* const* attr_keys,                    //
                  const size_t* key_lens, int n_keys,              //
                  Str* attr_val,                                   //
                  float* duration_us, uint64_t* trace_key,         //
                  uint8_t* is_error, uint32_t* attr_crc,           //
                  uint8_t* attr_present, int32_t* svc_idx,         //
                  int32_t* event_count, uint8_t* has_exception) {
  Str tid;
  uint64_t tid_num = 0;
  bool tid_is_num = false;
  uint64_t start = 0, end = 0;
  bool start_claimed = false, end_claimed = false;
  bool err = false;
  bool status_claimed = false;
  int32_t n_events = 0;
  bool exc = false;
  // attr_val is the CALLER's per-thread slot array (hoisted out of
  // the span loop: value-initializing all kMaxAttrKeys Str slots per
  // span costs more memory traffic than scanning the span itself);
  // only the first n_keys slots are live and reset here.
  for (int k = 0; k < n_keys; ++k) attr_val[k] = Str{};
  bool descend;

  Slice sp{p, n};
  Field pf;
  while (!sp.done()) {
    if (!next_field(sp, pf)) return false;
    switch (pf.no) {
      case 1:  // trace_id: first; bytes OR numeric both accepted
               // (SpanRecord.trace_id is bytes | int)
        if (!tid.set && !tid_is_num) {
          if (pf.wt == kLen) {
            tid.p = pf.val;
            tid.n = pf.len;
            tid.set = true;
          } else if (numeric(pf)) {
            tid_num = pf.num;
            tid_is_num = true;
          }
        }
        break;
      case 7:  // start_time_unix_nano (numeric-first)
        if (!numeric_first(pf, start_claimed, start)) return false;
        break;
      case 8:  // end_time_unix_nano (numeric-first)
        if (!numeric_first(pf, end_claimed, end)) return false;
        break;
      case 9: {  // attributes: repeated KeyValue (submessage-list)
        if (!sub_list(pf, descend)) return false;
        Str key, val;
        if (!keyvalue(pf.val, pf.len, key, val)) return false;
        if (val.set)
          for (int k = 0; k < n_keys; ++k)
            if (str_eq_n(key, attr_keys[k], key_lens[k])) attr_val[k] = val;
        break;
      }
      case 11: {  // events: repeated Event{time_unix_nano=1,
                  // name=2, attributes=3} (submessage-list).
        if (!sub_list(pf, descend)) return false;
        Slice ev{pf.val, pf.len};
        Field ef;
        Str ev_name;
        bool name_claimed = false;
        bool t_claimed = false;
        uint64_t t_ns = 0;
        while (!ev.done()) {
          if (!next_field(ev, ef)) return false;
          if (ef.no == 1) {  // time (numeric-first, empty-LEN ok)
            if (!numeric_first(ef, t_claimed, t_ns)) return false;
          } else if (ef.no == 2 && !name_claimed) {
            // Python: wire.first(ev, 2) then isinstance(bytes) —
            // a numeric first occurrence claims the slot with an
            // EMPTY name, never an error.
            name_claimed = true;
            if (ef.wt == kLen) {
              ev_name.p = ef.val;
              ev_name.n = ef.len;
              ev_name.set = true;
            }
          } else if (ef.no == 3) {  // attributes (submessage-list)
            if (!sub_list(ef, descend)) return false;
            Str key, val;
            if (!keyvalue(ef.val, ef.len, key, val)) return false;
          }
        }
        ++n_events;
        // tensorize.EXCEPTION_EVENT_NAMES, exact literals: the
        // semconv name, checkout's "error", ad's "Error".
        if (str_eq(ev_name, "exception") || str_eq(ev_name, "error") ||
            str_eq(ev_name, "Error"))
          exc = true;
        break;
      }
      case 15: {  // Status{code=3} (submessage-first)
        if (!sub_first(pf, status_claimed, descend)) return false;
        if (!descend) break;
        Slice st{pf.val, pf.len};
        Field stf;
        bool code_claimed = false;
        uint64_t code = 0;
        while (!st.done()) {
          if (!next_field(st, stf)) return false;
          if (stf.no == 3 && !numeric_first(stf, code_claimed, code))
            return false;
        }
        err = (code == 2);  // STATUS_CODE_ERROR
        break;
      }
      default:
        break;  // unknown: skipped, not descended
    }
  }

  duration_us[r] = end > start ? float(double(end - start) / 1000.0) : 0.0f;
  trace_key[r] = tid_is_num ? tid_num : key8(tid.p, tid.n);
  is_error[r] = err ? 1 : 0;
  uint32_t crc = 0;
  uint8_t present = 0;
  for (int k = 0; k < n_keys; ++k)
    if (attr_val[k].set) {  // priority order: first hit wins
      crc = crc32(attr_val[k].p, attr_val[k].n);
      present = 1;
      break;
    }
  attr_crc[r] = crc;
  attr_present[r] = present;
  svc_idx[r] = svc;
  event_count[r] = n_events;
  has_exception[r] = exc ? 1 : 0;
  return true;
}

void key_lengths(const char* const* attr_keys, int n_keys, size_t* out) {
  for (int k = 0; k < n_keys; ++k) out[k] = std::strlen(attr_keys[k]);
}

// Minimum spans per extraction shard: below this the std::thread
// spawn/join overhead exceeds the parse work a shard would cover.
constexpr int kMinShardSpans = 512;

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

}  // namespace

extern "C" {

// Error codes (negative returns).
// -1 malformed wire data; -2 record capacity exceeded; -3 service-name
// buffer exceeded; -4 too many monitored keys.

// Decode an ExportTraceServiceRequest into columns. One output row per
// span, in document order. `svc_idx[i]` indexes the i-th record's
// resource-spans entry; service names are written back-to-back into
// `svc_buf` with per-entry byte lengths in `svc_len` (length -1 ⇒ the
// resource had no service.name — distinct from a present-but-empty
// name, which the record path interns as ""). Monitored attribute keys
// come in priority order; the chosen value's CRC32 goes to attr_crc
// with attr_present=1. Span events (field 11; the reference services
// narrate spans with them — checkout main.go:270-294) surface as a
// per-span count plus a has_exception flag (event named "exception",
// "error", or "Error" — all three literals of
// tensorize.EXCEPTION_EVENT_NAMES: the OTel semconv name, checkout's
// lowercase variant, and the ad service's capitalized one), the
// error-cause evidence the detector folds into its error lane.
int otd_decode_otlp(const uint8_t* buf, size_t len,              //
                    const char* const* attr_keys, int n_keys,    //
                    int cap,                                     //
                    float* duration_us, uint64_t* trace_key,     //
                    uint8_t* is_error, uint32_t* attr_crc,       //
                    uint8_t* attr_present, int32_t* svc_idx,     //
                    int32_t* event_count, uint8_t* has_exception,  //
                    char* svc_buf, size_t svc_buf_cap,           //
                    int32_t* svc_len, int rs_cap,                //
                    int32_t* n_services) {
  if (n_keys > kMaxAttrKeys) return -4;
  int n_svc = 0;
  size_t svc_pos = 0;
  std::vector<SpanRef> spans;
  spans.reserve(len / 64 + 16);
  int n_rec = scan_request(
      buf, len, 0, svc_buf, svc_buf_cap, svc_len, rs_cap, &n_svc, &svc_pos,
      0, cap,
      [&](const uint8_t* p, size_t n, int svc, int payload, int row) {
        (void)payload;
        (void)row;
        spans.push_back(SpanRef{p, uint32_t(n), int32_t(svc), 0});
      });
  if (n_rec < 0) return n_rec;
  size_t key_lens[kMaxAttrKeys];
  key_lengths(attr_keys, n_keys, key_lens);
  Str attr_val[kMaxAttrKeys];
  for (int r = 0; r < n_rec; ++r) {
    const SpanRef& s = spans[r];
    if (!extract_span(s.p, s.len, s.svc, r, attr_keys, key_lens, n_keys,
                      attr_val, duration_us, trace_key, is_error, attr_crc,
                      attr_present, svc_idx, event_count, has_exception))
      return -1;
  }
  *n_services = n_svc;
  return n_rec;
}

// Pass 1 alone: structural scan of one ExportTraceServiceRequest into
// a caller-owned span index (`span_off`/`span_len` relative to `buf`,
// `span_svc` into the resource-spans list) — the raw-scanner surface
// `make decodebench` isolates, and the boundary oracle the fuzz suite
// truncates against. Returns the span count or -1/-2/-3.
int otd_scan_otlp(const uint8_t* buf, size_t len,                //
                  int32_t* span_off, int32_t* span_len,          //
                  int32_t* span_svc, int span_cap,               //
                  char* svc_buf, size_t svc_buf_cap,             //
                  int32_t* svc_len, int rs_cap,                  //
                  int32_t* n_services) {
  int n_svc = 0;
  size_t svc_pos = 0;
  int n = scan_request(
      buf, len, 0, svc_buf, svc_buf_cap, svc_len, rs_cap, &n_svc, &svc_pos,
      0, span_cap,
      [&](const uint8_t* p, size_t sn, int svc, int payload, int row) {
        (void)payload;
        span_off[row] = int32_t(p - buf);
        span_len[row] = int32_t(sn);
        span_svc[row] = int32_t(svc);
      });
  if (n < 0) return n;
  *n_services = n_svc;
  return n;
}

// Pass 2 alone: extract a caller-provided span index (from
// `otd_scan_otlp`) into columns — the other half of the raw-scanner
// microbench. Index bounds are re-validated against `len` so a stale
// or corrupted index can never read outside the payload. Returns
// `n_spans` or -1.
int otd_extract_otlp(const uint8_t* buf, size_t len,             //
                     const int32_t* span_off, const int32_t* span_len,
                     const int32_t* span_svc, int n_spans,       //
                     const char* const* attr_keys, int n_keys,   //
                     float* duration_us, uint64_t* trace_key,    //
                     uint8_t* is_error, uint32_t* attr_crc,      //
                     uint8_t* attr_present, int32_t* svc_idx,    //
                     int32_t* event_count, uint8_t* has_exception) {
  if (n_keys > kMaxAttrKeys) return -4;
  size_t key_lens[kMaxAttrKeys];
  key_lengths(attr_keys, n_keys, key_lens);
  Str attr_val[kMaxAttrKeys];
  for (int r = 0; r < n_spans; ++r) {
    size_t off = size_t(span_off[r]);
    size_t sn = size_t(span_len[r]);
    if (span_off[r] < 0 || span_len[r] < 0 || off + sn > len) return -1;
    if (!extract_span(buf + off, sn, span_svc[r], r, attr_keys, key_lens,
                      n_keys, attr_val, duration_us, trace_key, is_error,
                      attr_crc, attr_present, svc_idx, event_count,
                      has_exception))
      return -1;
  }
  return n_spans;
}

// Batched two-pass decode: `n_payloads` independent
// ExportTraceServiceRequests into ONE set of output columns (rows
// append across payloads in argument order; `svc_idx` indexes the
// shared, batch-wide resource-spans list). One ctypes round trip —
// during which ctypes has dropped the GIL — amortizes over the whole
// coalesced flush, which is the ingest pool's (runtime/ingest_pool.py)
// per-flush cost model.
//
// Pass 1 scans every payload serially (boundary work only), building
// the combined span index + service table; pass 2 extracts the index
// into the columns — sharded across up to `n_threads` OS threads at
// span-record boundaries (including mid-payload) whenever the batch
// carries at least `shard_min_bytes` of payload and enough spans to
// amortize a thread spawn. Because pass 1 fixed every row/service slot
// up front, shard writes are disjoint and need no synchronization.
//
// Per-payload verdicts land in `payload_rows`: the row count this
// payload contributed, or -1 when IT was malformed — a poison request
// never fails its batchmates (each receiver still answers 400 for
// exactly the bad request, the serial path's verdict). A pass-1
// failure contributes nothing (its partial index rolls back); a pass-2
// failure is compacted out by the single-threaded epilogue. Capacity
// exhaustion (-2/-3) aborts the whole call: the caller regrows its
// pooled buffers and retries everything. `scan_s`/`extract_s` (either
// may be null) report per-pass wall seconds for the phase histograms.
int otd_decode_otlp_many(const uint8_t* const* bufs, const size_t* lens,
                         int n_payloads,                          //
                         const char* const* attr_keys, int n_keys,  //
                         int cap,                                  //
                         float* duration_us, uint64_t* trace_key,  //
                         uint8_t* is_error, uint32_t* attr_crc,    //
                         uint8_t* attr_present, int32_t* svc_idx,  //
                         int32_t* event_count, uint8_t* has_exception,  //
                         char* svc_buf, size_t svc_buf_cap,        //
                         int32_t* svc_len, int rs_cap,             //
                         int32_t* n_services, int32_t* payload_rows,
                         int n_threads, long long shard_min_bytes,
                         double* scan_s, double* extract_s) {
  if (n_keys > kMaxAttrKeys) return -4;
  auto t0 = std::chrono::steady_clock::now();

  // ---- pass 1: structural scan, batch-wide index --------------------
  // The index rides a thread_local vector: each pool worker's calls
  // reuse one high-watermark allocation instead of paying a
  // payload-sized malloc/free per flush (the same retention policy as
  // the Python-side DecodeScratch freelist). clear() keeps capacity.
  static thread_local std::vector<SpanRef> spans_tls;
  std::vector<SpanRef>& spans = spans_tls;
  spans.clear();
  size_t total_bytes = 0;
  for (int i = 0; i < n_payloads; ++i) total_bytes += lens[i];
  if (spans.capacity() < total_bytes / 64 + 16)
    spans.reserve(total_bytes / 64 + 16);
  // Per-payload bookkeeping for the epilogue: row/service/name-byte
  // ranges as committed by pass 1 (rolled-back payloads collapse to
  // empty ranges).
  std::vector<int> row0(n_payloads + 1), svc0(n_payloads + 1);
  std::vector<size_t> pos0(n_payloads + 1);
  int n_svc = 0;
  size_t svc_pos = 0;
  bool any_bad = false;
  auto emit = [&](const uint8_t* p, size_t n, int svc, int payload,
                  int row) {
    (void)row;
    spans.push_back(SpanRef{p, uint32_t(n), int32_t(svc), int32_t(payload)});
  };
  for (int i = 0; i < n_payloads; ++i) {
    row0[i] = int(spans.size());
    svc0[i] = n_svc;
    pos0[i] = svc_pos;
    int r = scan_request(bufs[i], lens[i], i, svc_buf, svc_buf_cap,
                         svc_len, rs_cap, &n_svc, &svc_pos,
                         int(spans.size()), cap, emit);
    if (r == -2 || r == -3) return r;  // shared capacity: retry all
    if (r < 0) {
      // Malformed framing: roll back this payload's partial appends
      // (append-only writes — restoring the counters IS the rollback).
      payload_rows[i] = -1;
      spans.resize(size_t(row0[i]));
      n_svc = svc0[i];
      svc_pos = pos0[i];
      any_bad = true;
    } else {
      payload_rows[i] = r - row0[i];
    }
  }
  row0[n_payloads] = int(spans.size());
  svc0[n_payloads] = n_svc;
  pos0[n_payloads] = svc_pos;
  int n_rec = int(spans.size());
  if (scan_s) *scan_s = seconds_since(t0);
  auto t1 = std::chrono::steady_clock::now();

  // ---- pass 2: extraction, sharded at span-record boundaries --------
  size_t key_lens[kMaxAttrKeys];
  key_lengths(attr_keys, n_keys, key_lens);
  const size_t n_pl = size_t(n_payloads);
  std::vector<std::atomic<int>> bad(n_pl);
  for (auto& b : bad) b.store(0, std::memory_order_relaxed);
  std::atomic<bool> bad_seen{false};
  auto extract_range = [&](int lo, int hi) {
    Str attr_val[kMaxAttrKeys];  // per-thread: shards never share it
    for (int k = lo; k < hi; ++k) {
      const SpanRef& s = spans[size_t(k)];
      if (bad[size_t(s.payload)].load(std::memory_order_relaxed))
        continue;  // owning payload already condemned: skip the work
      if (!extract_span(s.p, s.len, s.svc, k, attr_keys, key_lens, n_keys,
                        attr_val, duration_us, trace_key, is_error,
                        attr_crc, attr_present, svc_idx, event_count,
                        has_exception)) {
        bad[size_t(s.payload)].store(1, std::memory_order_relaxed);
        bad_seen.store(true, std::memory_order_relaxed);
      }
    }
  };
  int shards = 1;
  if (n_threads > 1 && (long long)total_bytes >= shard_min_bytes)
    shards = n_threads;
  if (shards > n_rec / kMinShardSpans)
    shards = n_rec / kMinShardSpans;  // don't spawn for trivial work
  if (shards <= 1) {
    extract_range(0, n_rec);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(size_t(shards - 1));
    int per = (n_rec + shards - 1) / shards;
    for (int t = 1; t < shards; ++t)
      pool.emplace_back(extract_range, t * per,
                        t * per + per < n_rec ? t * per + per : n_rec);
    extract_range(0, per < n_rec ? per : n_rec);
    for (auto& th : pool) th.join();
  }

  // ---- epilogue: compact condemned payloads back out ----------------
  if (bad_seen.load(std::memory_order_relaxed)) any_bad = true;
  if (any_bad && n_rec) {
    int wr = 0;        // write row
    int wsvc = 0;      // write service entry
    size_t wpos = 0;   // write name byte
    for (int i = 0; i < n_payloads; ++i) {
      int r0 = row0[i], cnt = row0[i + 1] - row0[i];
      int s0 = svc0[i], scnt = svc0[i + 1] - svc0[i];
      size_t p0 = pos0[i], pbytes = pos0[i + 1] - pos0[i];
      if (payload_rows[i] < 0) continue;  // pass-1 bad: empty ranges
      if (bad[size_t(i)].load(std::memory_order_relaxed)) {
        payload_rows[i] = -1;  // pass-2 bad: drop rows + services
        continue;
      }
      payload_rows[i] = cnt;
      int svc_shift = s0 - wsvc;
      if (wr != r0 || svc_shift) {
        std::memmove(duration_us + wr, duration_us + r0,
                     size_t(cnt) * sizeof(float));
        std::memmove(trace_key + wr, trace_key + r0,
                     size_t(cnt) * sizeof(uint64_t));
        std::memmove(is_error + wr, is_error + r0, size_t(cnt));
        std::memmove(attr_crc + wr, attr_crc + r0,
                     size_t(cnt) * sizeof(uint32_t));
        std::memmove(attr_present + wr, attr_present + r0, size_t(cnt));
        for (int k = 0; k < cnt; ++k)
          svc_idx[wr + k] = svc_idx[r0 + k] - svc_shift;
        std::memmove(event_count + wr, event_count + r0,
                     size_t(cnt) * sizeof(int32_t));
        std::memmove(has_exception + wr, has_exception + r0, size_t(cnt));
        std::memmove(svc_len + wsvc, svc_len + s0,
                     size_t(scnt) * sizeof(int32_t));
        std::memmove(svc_buf + wpos, svc_buf + p0, pbytes);
      }
      wr += cnt;
      wsvc += scnt;
      wpos += pbytes;
    }
    n_rec = wr;
    n_svc = wsvc;
  }
  if (extract_s) *extract_s = seconds_since(t1);
  *n_services = n_svc;
  return n_rec;
}

// USD-normalization table for the order value lane, installed from
// Python (currency_data.EUR_RATES) via otd_set_order_rates. Codes are
// fixed 8-byte NUL-padded entries; unknown codes pass through at 1.0
// (kafka_orders.to_usd_factor contract).
static struct OrderRate {
  char code[8];
  double factor;
} g_order_rates[64];
static int g_n_order_rates = 0;

void otd_set_order_rates(const char* codes, const double* factors, int n) {
  if (n > 64) n = 64;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 8; ++j) g_order_rates[i].code[j] = codes[i * 8 + j];
    g_order_rates[i].factor = factors[i];
  }
  g_n_order_rates = n;
}

static double order_rate_lookup(const uint8_t* p, size_t len) {
  if (len == 0 || len > 8) return 1.0;
  for (int i = 0; i < g_n_order_rates; ++i) {
    const char* c = g_order_rates[i].code;
    size_t clen = 0;
    while (clen < 8 && c[clen]) ++clen;
    if (clen != len) continue;
    bool eq = true;
    for (size_t j = 0; j < len; ++j)
      if ((uint8_t)c[j] != p[j]) { eq = false; break; }
    if (eq) return g_order_rates[i].factor;
  }
  return 1.0;
}

// Decode a batch of OrderResult payloads (one Kafka message each) into
// the detector's order-record columns: order-id key (first 8 bytes of
// the id string), shipping cost USD-normalized via the installed rate
// table (the value lane), and the CRC of the first *non-empty* product
// id (heavy-hitter attribute — kafka_orders.decode_order skips falsy
// ids). Mirrors decode_order + order_to_record, including error
// verdicts.
int otd_decode_orders(const uint8_t* const* bufs, const size_t* lens,
                      int n,                                     //
                      float* value_units, uint64_t* order_key,   //
                      uint32_t* attr_crc) {
  for (int i = 0; i < n; ++i) {
    Slice top{bufs[i], lens[i]};
    Field f;
    bool descend;
    Str order_id, tracking, first_product, currency;
    bool money_claimed = false;
    uint64_t units = 0, nanos = 0;
    bool units_claimed = false, nanos_claimed = false;
    while (!top.done()) {
      if (!next_field(top, f)) return -1;
      switch (f.no) {
        case 1:  // order_id (bytes-first)
          if (!bytes_first(f, order_id)) return -1;
          break;
        case 2:  // shipping_tracking_id (bytes-first; decoded by Python
                 // even though unused here, so verdicts must match)
          if (!bytes_first(f, tracking)) return -1;
          break;
        case 3: {  // shipping_cost Money{units=2, nanos=3}
          if (!sub_first(f, money_claimed, descend)) return -1;
          if (!descend) break;
          Slice m{f.val, f.len};
          Field mf;
          while (!m.done()) {
            if (!next_field(m, mf)) return -1;
            if (mf.no == 1) {
              // currency_code: bytes-first, EXCEPT Python's
              // isinstance(code, bytes) guard (_money_units) maps a
              // numeric value to the USD default instead of raising —
              // so a nonzero varint claims-with-default here, unlike
              // every other bytes field in this decoder.
              if (!bytes_first(mf, currency)) {
                if (!numeric(mf)) return -1;
                currency.set = true;  // claimed, empty → USD factor
              }
            } else if (mf.no == 2) {
              // float(first(...)) raises on b"" — no empty-LEN default.
              if (!numeric_first(mf, units_claimed, units, false))
                return -1;
            } else if (mf.no == 3) {
              if (!numeric_first(mf, nanos_claimed, nanos, false))
                return -1;
            }
          }
          break;
        }
        case 5: {  // items: OrderItem{item=1 CartItem{product_id=1,
                   // quantity=2}} (submessage-list)
          if (!sub_list(f, descend)) return -1;
          Slice it{f.val, f.len};
          Field itf;
          bool cart_claimed = false;
          while (!it.done()) {
            if (!next_field(it, itf)) return -1;
            if (itf.no != 1) continue;
            if (!sub_first(itf, cart_claimed, descend)) return -1;
            if (!descend) continue;
            Slice cart{itf.val, itf.len};
            Field cf;
            Str pid;
            bool qty_claimed = false;
            uint64_t qty = 0;
            while (!cart.done()) {
              if (!next_field(cart, cf)) return -1;
              if (cf.no == 1) {
                if (!bytes_first(cf, pid)) return -1;
              } else if (cf.no == 2) {
                if (!numeric_first(cf, qty_claimed, qty)) return -1;
              }
            }
            // decode_order: `if pid: products.append(...)` — empty ids
            // are skipped, so the first NON-empty product wins.
            if (pid.set && pid.n > 0 && !first_product.set)
              first_product = pid;
          }
          break;
        }
        default:
          break;
      }
    }
    // Parity with wire.py: varints decode unsigned, and _money_units
    // floats the raw value (negative money is producer error; both
    // sides treat it identically). USD normalization matches
    // order_to_record: float32(float64 value × float64 factor).
    double factor = currency.set ? order_rate_lookup(currency.p, currency.n)
                                 : order_rate_lookup((const uint8_t*)"USD", 3);
    value_units[i] = float((double(units) + double(nanos) * 1e-9) * factor);
    order_key[i] =
        order_id.set && order_id.n ? key8(order_id.p, order_id.n) : 0;
    attr_crc[i] =
        first_product.set ? crc32(first_product.p, first_product.n) : 0;
  }
  return n;
}

// CRC32 of one buffer — exposed so Python-side fallbacks/tests can
// assert the hash contract without zlib.
uint32_t otd_crc32(const uint8_t* p, size_t n) { return crc32(p, n); }

// CRC-32C with a running seed (0 to start): the frame checksum
// (runtime/frame.py). Called with the GIL released like every foreign
// call here — column verify overlaps other workers' Python.
uint32_t otd_crc32c(const uint8_t* p, size_t n, uint32_t seed) {
  return crc32c_update(seed, p, n);
}

}  // extern "C"
