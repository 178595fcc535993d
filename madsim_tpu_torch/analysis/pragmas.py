"""Finding records and inline suppression pragmas for speclint.

The port's copy of the part of ``madsim_tpu/analysis/pragmas.py`` that
passes 3 and 4 use: :class:`Finding`, :func:`extract_pragmas`,
:func:`apply_pragmas` and :class:`Allowlist`. A ``# detlint:
allow[SPC030]`` comment on (or immediately above) the offending line
suppresses that finding; a pragma that suppresses nothing is itself an
error (DET900), so allow-comments cannot rot in place after the code they
excused changes. An allowlist file (``path-prefix[:RULE]`` lines),
given to ``analysis trace --allowlist``, applies to tracelint's
``trace/<program>`` pseudo-paths.
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, List, NamedTuple, Optional, Tuple


class Finding(NamedTuple):
    path: str       # scan-root-relative, '/' separators
    line: int       # 1-based
    rule: str       # e.g. "SPC030"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_PRAGMA_RE = re.compile(
    r"#\s*detlint:\s*allow\[([A-Za-z0-9_,\s]+)\](?:\s+reason=(\S[^#]*))?")


def extract_pragmas(source: str) -> Dict[int, Tuple[int, Dict[str, Optional[str]]]]:
    """Map *effective* line -> (pragma line, {rule code: reason or None}).

    Tokenized, not line-grepped: only real COMMENT tokens count, so a
    pragma example quoted inside a docstring is documentation, not a
    suppression. A pragma trailing code covers its own line; a pragma on
    a comment-only line covers the next line. The optional ``reason=...``
    tail is captured per pragma and applies to every code the bracket
    names.
    """
    out: Dict[int, Tuple[int, Dict[str, Optional[str]]]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m is None:
                continue
            reason = m.group(2).strip() if m.group(2) else None
            codes = {c.strip().upper(): reason
                     for c in m.group(1).split(",") if c.strip()}
            line = tok.start[0]
            comment_only = tok.line[:tok.start[1]].strip() == ""
            target = line + 1 if comment_only else line
            prev_line, prev_codes = out.get(target, (line, {}))
            merged = dict(prev_codes)
            merged.update(codes)
            out[target] = (prev_line, merged)
    except (tokenize.TokenError, IndentationError):
        pass  # an unparseable source has no pragmas to apply
    return out


def apply_pragmas(findings: List[Finding],
                  pragmas: Dict[int, Tuple[int, Dict[str, Optional[str]]]],
                  path: str,
                  owned_prefixes: Optional[Tuple[str, ...]] = None,
                  ) -> List[Finding]:
    """Drop findings covered by a pragma; emit DET900 for unused codes.

    ``owned_prefixes`` scopes the staleness check: a pass reports DET900
    only for codes whose prefix it owns (pass 4 owns SPC), so a pragma
    meant for another pass does not read as stale. ``None`` checks every
    code. (The JAX module also requires a ``reason=`` tail on its
    hot-loop sync waivers, DET008/DET009; those codes are not SPC codes,
    so pass 4 never checks them.)
    """
    used: Dict[Tuple[int, str], bool] = {}
    for line, (_pline, codes) in pragmas.items():
        for code in codes:
            used[(line, code)] = False
    kept: List[Finding] = []
    for f in findings:
        entry = pragmas.get(f.line)
        if entry is not None and f.rule in entry[1]:
            used[(f.line, f.rule)] = True
            continue
        kept.append(f)
    for line, (pline, codes) in sorted(pragmas.items()):
        for code in sorted(codes):
            if owned_prefixes is not None and \
                    not code.startswith(owned_prefixes):
                continue
            if not used.get((line, code), False):
                kept.append(Finding(
                    path, pline, "DET900",
                    f"pragma allows {code} but line {line} has no {code} "
                    f"finding — delete the stale pragma"))
    kept.sort(key=lambda f: (f.line, f.rule))
    return kept


class Allowlist:
    """``path-prefix[:RULE]`` entries; '#' starts a comment (the JAX
    package's class, less the stale-entry report of passes 1-2)."""

    def __init__(self, entries: List[Tuple[str, Optional[str]]]):
        self._entries = list(entries)

    @classmethod
    def parse(cls, text: str) -> "Allowlist":
        entries: List[Tuple[str, Optional[str]]] = []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            prefix, _, rule = line.partition(":")
            entries.append((prefix.strip(), rule.strip().upper() or None))
        return cls(entries)

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        with open(path, encoding="utf-8") as f:
            return cls.parse(f.read())

    def allows(self, finding: Finding) -> bool:
        return any(finding.path.startswith(prefix)
                   and (rule is None or rule == finding.rule)
                   for prefix, rule in self._entries)

    def filter(self, findings: List[Finding]) -> List[Finding]:
        return [f for f in findings if not self.allows(f)]
