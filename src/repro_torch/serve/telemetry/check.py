"""Artifact validator CLI for the serve telemetry artifacts.

    python -m repro_torch.serve.telemetry.check m.json [--trace t.json]

Loads a metrics snapshot written by `launch/serve.py --metrics-json` and
validates it against the engine metric taxonomy (`schema.py`): current
schema version, every required metric present, no unknown names, bucket
counts consistent. With `--trace`, additionally validates the Chrome
Trace JSON (`trace.validate_trace`): required keys per phase, B/E
nesting, non-negative durations. Exits non-zero with the full problem
list on any violation, so a telemetry regression fails whatever runs the
check instead of silently shipping a partial snapshot.
"""
from __future__ import annotations

import argparse
import json
import sys

from .schema import validate_snapshot
from .trace import validate_trace


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="validate serve telemetry artifacts")
    ap.add_argument("metrics", help="metrics snapshot JSON "
                    "(from launch/serve.py --metrics-json)")
    ap.add_argument("--trace", default=None,
                    help="Chrome Trace JSON (from --trace) to validate too")
    args = ap.parse_args(argv)

    with open(args.metrics) as f:
        snap = json.load(f)
    try:
        validate_snapshot(snap)
    except ValueError as e:
        print(f"FAIL {args.metrics}: {e}", file=sys.stderr)
        return 1
    n_named = sum(len(snap.get(s, {}))
                  for s in ("counters", "gauges", "histograms"))
    print(f"ok {args.metrics}: schema v{snap['schema_version']}, "
          f"{n_named} metrics")

    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        try:
            n_events = validate_trace(trace)
        except ValueError as e:
            print(f"FAIL {args.trace}: {e}", file=sys.stderr)
            return 1
        print(f"ok {args.trace}: {n_events} well-formed trace events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
