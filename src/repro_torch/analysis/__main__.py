"""CLI: ``python -m repro_torch.analysis [--check] [--report PATH]
[--no-steps] [--no-mesh]``.

Runs both analysis layers over the port and prints every active
finding. ``--check`` exits non-zero when any non-allowlisted finding
remains. The step layer traces on the CPU; its mesh traces spawn one
gloo world of CPU processes for each mesh of ``stepcheck.MESHES`` (1x2
and 2x2), which ``--no-mesh`` skips (~30 s each).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="SPARQLe port invariant checker (AST rules + traced "
                    "step contracts)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any non-allowlisted finding remains")
    ap.add_argument("--report", metavar="PATH",
                    help="write a JSON findings report")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the traced-step layer (AST rules only)")
    ap.add_argument("--no-mesh", action="store_true",
                    help="skip the mesh-sharded step traces")
    args = ap.parse_args(argv)

    from . import VERSION, astlint, ruleset_hash
    from .findings import Allowlist, apply_allowlist

    here = os.path.dirname(os.path.abspath(__file__))
    src_root = os.path.abspath(os.path.join(here, "..", ".."))
    docs = os.path.join(os.path.dirname(src_root), "docs", "observability.md")

    findings = astlint.run(src_root, docs_path=docs)
    if not args.no_steps:
        from . import stepcheck
        findings += stepcheck.run(with_mesh=not args.no_mesh)

    allowlist = Allowlist.load()
    active, allowed = apply_allowlist(findings, allowlist)

    for f in active:
        print(f.render())
    print(f"repro_torch.analysis v{VERSION} (ruleset {ruleset_hash()}): "
          f"{len(active)} finding(s), {len(allowed)} allowlisted")
    stale = allowlist.stale_entries()
    if args.no_steps:       # TXP entries can't match when the layer is skipped
        stale = [e for e in stale if not e.rule_id.startswith("TXP")]
    elif args.no_mesh:      # collectives run on a mesh only
        stale = [e for e in stale if e.rule_id != "TXP001"]
    for e in stale:
        print(f"warning: stale allowlist entry (matched nothing): "
              f"{allowlist.path}:{e.line_no} {e.rule_id} {e.pattern}")

    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "version": VERSION,
                "ruleset_hash": ruleset_hash(),
                "findings": [x.as_dict() for x in active],
                "allowlisted": [x.as_dict() for x in allowed],
                "stale_allowlist_entries": [
                    {"rule_id": e.rule_id, "pattern": e.pattern,
                     "reason": e.reason, "line": e.line_no}
                    for e in stale],
            }, f, indent=2)
        print(f"report written to {args.report}")

    return 1 if (args.check and active) else 0


if __name__ == "__main__":
    sys.exit(main())
