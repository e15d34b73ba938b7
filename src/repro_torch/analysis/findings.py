"""Findings + allowlist plumbing shared by both analysis layers (a copy
of ``repro.analysis.findings``: the same file format and match rules).

A ``Finding`` is one rule violation: rule ID, a *stable* match key (used
for allowlisting — ``file::symbol`` for AST rules,
``<step-kind>:<op>:<group>:<dtype>`` for collectives), human-readable
provenance (file:line or graph node) and a message.

The committed allowlist (``src/repro_torch/analysis/allowlist.txt``)
holds intentionally kept findings, one per line::

    RULE_ID  MATCH_KEY  reason the violation is deliberate

``MATCH_KEY`` is matched with ``fnmatch`` so entries may use ``*``
wildcards (``*:all_reduce_sum:model:int32`` covers every step kind).
Every entry must carry a reason string; entries that match nothing are
reported as stale so the file cannot silently rot.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Dict, List, Tuple

ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__), "allowlist.txt")


@dataclass
class Finding:
    rule_id: str          # e.g. "SPL001", "TXP002"
    key: str              # stable allowlist match key
    provenance: str       # file:line or "step=<name> node#<i> <op>"
    message: str
    allowlisted: bool = False
    allow_reason: str = ""

    def render(self) -> str:
        tag = " [allowlisted: %s]" % self.allow_reason if self.allowlisted \
            else ""
        return f"{self.rule_id} {self.provenance}: {self.message}{tag}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule_id": self.rule_id, "key": self.key,
            "provenance": self.provenance, "message": self.message,
            "allowlisted": self.allowlisted,
            "allow_reason": self.allow_reason,
        }


@dataclass
class AllowEntry:
    rule_id: str
    pattern: str
    reason: str
    line_no: int
    hits: int = 0


@dataclass
class Allowlist:
    entries: List[AllowEntry] = field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str = ALLOWLIST_PATH) -> "Allowlist":
        al = cls(path=path)
        if not os.path.exists(path):
            return al
        with open(path) as f:
            for i, raw in enumerate(f, start=1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 2)
                if len(parts) < 3:
                    raise ValueError(
                        f"{path}:{i}: allowlist entries need "
                        f"'RULE_ID KEY reason...', got: {line!r}")
                al.entries.append(AllowEntry(parts[0], parts[1], parts[2], i))
        return al

    def match(self, finding: Finding) -> AllowEntry | None:
        for e in self.entries:
            if e.rule_id == finding.rule_id and \
                    fnmatchcase(finding.key, e.pattern):
                return e
        return None

    def stale_entries(self) -> List[AllowEntry]:
        return [e for e in self.entries if e.hits == 0]


def apply_allowlist(findings: List[Finding],
                    allowlist: Allowlist) -> Tuple[List[Finding],
                                                   List[Finding]]:
    """Split findings into (active, allowlisted); marks matches in place."""
    active, allowed = [], []
    for f in findings:
        e = allowlist.match(f)
        if e is not None:
            e.hits += 1
            f.allowlisted, f.allow_reason = True, e.reason
            allowed.append(f)
        else:
            active.append(f)
    return active, allowed
