"""Host-ingest throughput: protobuf OTLP bytes → pipeline columns.

The other half of the ingest budget, on the host (no card): wire decode,
attribute hashing and interning, for three engines over the same bytes:

- the Python record decoder (the plain version),
- the serial native path (one C++ decode and one tensorize per request),
- the decode pool (``runtime.ingest_pool``: batched decode, pooled
  buffers, coalesced tensorize) swept over ``--workers``.

The method is ``runtime.ingestbench``'s, shared with the bench line's
``host_ingest_*`` fields. ``--raw`` times the native two passes alone
(scan, extract, the whole call) and one fat payload across threads.
There is no fallback: without the native decoder this raises with the
compiler's error.

Usage: python -m opentelemetry_demo_tpu_torch.scripts.bench_ingest
       [--workers 1,2,4] [--raw]
"""

from __future__ import annotations

import argparse

from ..runtime import ingestbench


def _print_fat_scaling() -> None:
    fat = ingestbench.measure_fat_payload_scaling()
    legs = "  ".join(f"{t}thr={fat[t]/1e6:.2f}M/s" for t in sorted(k for k in fat if k != "scaling"))
    print(f"one fat payload:      {legs}  scaling={fat['scaling']}x")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", default="1,2,4",
                        help="comma-separated decode-pool worker counts to sweep")
    parser.add_argument("--raw", action="store_true",
                        help="raw two-pass scanner microbench only: pass-1 scan vs pass-2 "
                        "extract vs whole-call throughput per thread")
    args = parser.parse_args(argv)
    workers = [int(w) for w in args.workers.split(",") if w.strip()]

    if args.raw:
        raw = ingestbench.measure_raw()
        print(f"pass-1 scan:          {raw['scan_spans_per_sec']/1e6:8.2f} M spans/s"
              f"  ({raw['scan_bytes_per_sec']/1e6:7.1f} MB/s)")
        print(f"pass-2 extract:       {raw['extract_spans_per_sec']/1e6:8.2f} M spans/s")
        print(f"decode_many (1 thr):  {raw['decode_spans_per_sec']/1e6:8.2f} M spans/s")
        _print_fat_scaling()
        return

    payloads = ingestbench.make_payloads()  # built once, shared by all
    py = ingestbench.measure_python(payloads=payloads)
    print(f"python-records:        {py/1e3:10.1f} k spans/s")
    nat = ingestbench.measure_native(payloads=payloads)
    print(f"native-serial:         {nat/1e3:10.1f} k spans/s  (one decode a request)")
    for w in workers:
        got = ingestbench.measure_pooled_detail(workers=w, payloads=payloads)
        rate = got["spans_per_sec"]
        share = got["phase_share"]
        phases = " ".join(
            f"{name}={share.get(name, 0.0):.0%}" for name in ("decode", "verify", "tensorize", "submit")
        )
        split = got.get("decode_split") or {}
        split_s = (
            f"  decode: scan={split.get('scan', 0.0):.0%} extract={split.get('extract', 0.0):.0%}"
            if split else ""
        )
        print(f"pool workers={w}:        {rate/1e3:10.1f} k spans/s"
              f"  ({rate/nat:4.2f}x serial)  [{phases}]{split_s}")
    _print_fat_scaling()


if __name__ == "__main__":
    main()
