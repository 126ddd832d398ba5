"""Registry-generated docs of the port: ``python -m repro_torch.docs``.

The reference's ``repro.docs`` renders its five registries into README.md;
this is the same for the port's registries, into the README's port
section, between markers of its own (``<!-- generated:torch-NAME ... -->``
and ``<!-- end:generated:torch-NAME -->``) that the reference's
``--check`` does not read:

- attacks:     ``repro_torch.attacks.registered()``;
- aggregators: ``repro_torch.core.aggregators.registered_aggregators()``;
- strategies:  ``repro_torch.rounds.comm.registered_strategies()``;
- compression: ``repro_torch.rounds.compression.registered_compressions()``;
- policies:    ``repro_torch.fed.staleness.registered_policies()``.

Everything outside the markers is hand-written and untouched.

Usage::

    PYTHONPATH=src python -m repro_torch.docs            # rewrite README.md
    PYTHONPATH=src python -m repro_torch.docs --check    # fail (exit 1) on drift
"""
from __future__ import annotations

import argparse
import os
import re
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_README = os.path.normpath(os.path.join(_HERE, "..", "..", "README.md"))

BEGIN = "<!-- generated:torch-{name} (python -m repro_torch.docs; do not edit by hand) -->"
END = "<!-- end:generated:torch-{name} -->"


def _cell(c) -> str:
    # literal pipes (|g| in the byte formulas) must be escaped inside
    # markdown table cells
    return str(c).replace("|", "\\|")


def _md_table(header, rows) -> str:
    lines = ["| " + " | ".join(header) + " |",
             "|" + "|".join("---" for _ in header) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(_cell(c) for c in r) + " |")
    return "\n".join(lines)


def attack_table() -> str:
    from repro_torch import attacks

    rows = []
    for name in attacks.registered():
        a = attacks.get_attack(name)
        flags = [f for f, on in (
            ("adaptive", a.adaptive),
            ("randomized", a.randomized),
            ("needs-variance", a.needs_variance),
            ("reads-own", a.reads_own),
        ) if on]
        if a.arrival is not None:
            # times its arrival into the async buffer window
            flags.append(f"times-arrival:{a.arrival}")
        rows.append((
            f"`{a.name}`",
            a.access + (" (**adaptive**)" if a.adaptive else ""),
            ", ".join(flags) if flags else "—",
            f"{a.strength:g}" if a.payload is not None
            or a.access == "feedback" else "—",
            a.summary,
        ))
    return _md_table(
        ("attack", "access", "flags", "default strength", "payload"), rows)


def aggregator_table() -> str:
    from repro_torch.core import aggregators

    rows = []
    for name in aggregators.registered_aggregators():
        s = aggregators.get_aggregator_spec(name)
        rows.append((
            f"`{s.name}`",
            "exact" if s.exact else "approx",
            s.breakdown,
            s.summary,
        ))
    return _md_table(
        ("aggregator", "estimator", "breakdown point", "note"), rows)


def strategy_table() -> str:
    from repro_torch.rounds import comm

    rows = []
    for name in comm.registered_strategies():
        s = comm.get_strategy_spec(name)
        rows.append((
            f"`{s.name}`",
            "exact" if s.exact else "approx",
            s.bytes_formula,
            s.max_access,
            s.summary,
        ))
    return _md_table(
        ("strategy", "estimator", "collective bytes / device·round",
         "max attack access", "note"), rows)


def compression_table() -> str:
    from repro_torch.rounds import compression

    rows = []
    for name in compression.registered_compressions():
        s = compression.get_compression(name)
        rows.append((
            f"`{s.name}`",
            s.bytes_formula,
            f"{s.rate_penalty:g}x",
            "yes" if s.error_feedback else "no",
            s.summary,
        ))
    return _md_table(
        ("compression", "payload bytes", "rate penalty", "error feedback",
         "note"), rows)


def policy_table() -> str:
    from repro_torch.fed import staleness

    rows = []
    for name in staleness.registered_policies():
        s = staleness.get_policy(name)
        behaviour = []
        if s.extra_trim:
            behaviour.append("widens trim")
        if s.drops_late:
            behaviour.append(f"drops s > cap (default {s.cap})")
        # show the weight at s=2 with the default knob so the discount
        # curve is visible without reading the lambda
        w2 = float(s.weight(2))
        rows.append((
            f"`{s.name}`",
            f"w(2) = {w2:g} (knob {s.knob:g})" if w2 != 1.0 else "1 (no reweight)",
            ", ".join(behaviour) if behaviour else "—",
            s.summary,
        ))
    return _md_table(
        ("policy", "staleness weight", "buffer behaviour", "note"), rows)


TABLES = {
    "attacks": attack_table,
    "aggregators": aggregator_table,
    "strategies": strategy_table,
    "compression": compression_table,
    "policies": policy_table,
}


def render(text: str) -> str:
    """Replace every generated block in ``text`` with fresh registry
    content.  Raises if a marker pair is missing or malformed — a README
    without the markers cannot be kept in sync."""
    for name, build in TABLES.items():
        begin, end = BEGIN.format(name=name), END.format(name=name)
        if begin not in text or end not in text:
            raise ValueError(
                f"README is missing the generated-block markers for {name!r}: "
                f"expected {begin!r} .. {end!r}")
        pattern = re.compile(
            re.escape(begin) + r".*?" + re.escape(end), flags=re.DOTALL)
        if len(pattern.findall(text)) != 1:
            raise ValueError(f"marker pair for {name!r} must appear exactly once")
        text = pattern.sub(begin + "\n" + build() + "\n" + end, text)
    return text


def check(readme: str = DEFAULT_README) -> list:
    """Return a list of drift problems (empty = README matches registries)."""
    with open(readme) as f:
        current = f.read()
    try:
        fresh = render(current)
    except ValueError as e:
        return [str(e)]
    if fresh != current:
        return [f"{readme} is out of date with the registries; "
                "regenerate with: PYTHONPATH=src python -m repro_torch.docs"]
    return []


def write(readme: str = DEFAULT_README) -> bool:
    """Regenerate in place; returns True if the file changed."""
    with open(readme) as f:
        current = f.read()
    fresh = render(current)
    if fresh != current:
        with open(readme, "w") as f:
            f.write(fresh)
        return True
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.docs",
        description="Regenerate the port's registry-backed README tables "
                    "(attacks, aggregators, collective strategies, "
                    "compression codecs, staleness policies)")
    ap.add_argument("--check", action="store_true",
                    help="verify the tables match the registries; exit 1 on "
                         "drift without writing anything")
    ap.add_argument("--readme", default=DEFAULT_README, metavar="PATH")
    args = ap.parse_args(argv)
    if args.check:
        problems = check(args.readme)
        for p in problems:
            print(f"DOCS DRIFT: {p}", file=sys.stderr)
        if not problems:
            print(f"{args.readme}: generated tables up to date")
        return 1 if problems else 0
    changed = write(args.readme)
    print(f"{args.readme}: {'updated' if changed else 'already up to date'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
