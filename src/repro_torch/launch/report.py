"""Turn the port's dry-run JSONL (``dryrun_torch_results.jsonl``) into the
dry-run, roofline and perf tables (markdown; the reference's
``repro.launch.report`` with the port's field names and the H100 SXM's
data-sheet constants at 700 W: computed, not measured).

    python -m repro_torch.launch.report [--in dryrun_torch_results.jsonl]
        [--section dryrun|roofline|perf|summary|all]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import cost_analysis
from repro_torch.launch.roofline import NET_BW, collective_seconds, format_seconds


def recompute_collective(r):
    """The collective term from each axis's wire bytes (all-reduce 2x) at the
    record's links, uniform across old and new records."""
    wire = {a: cost_analysis.wire_bytes(c) for a, c in r.get("collectives_by_axis", {}).items()}
    r["collective_s"] = collective_seconds(wire, r.get("links") or {a: NET_BW for a in wire})
    r["dominant"] = max(("compute", r["compute_s"]), ("memory", r["memory_s"]),
                        ("collective", r["collective_s"]), key=lambda kv: kv[1])[0]
    return r


def load(path: str):
    seen = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r.get("arch"), r.get("shape"), r.get("mesh"), r.get("strategy", ""),
                   r.get("param_mode", ""), r.get("attn_chunk", ""),
                   r.get("seq_parallel", False), r.get("device_steps", 1))
            if r.get("status") == "ok":
                r = recompute_collective(r)
            seen[key] = r  # the last record wins
    return list(seen.values())


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if b >= div:
            return f"{b/div:.1f}{unit}"
    return f"{b:.0f}B"


def _default(r) -> bool:
    return (r.get("strategy", "gather") == "gather"
            and r.get("param_mode", "replicated") == "replicated"
            and r.get("device_steps", 1) == 1)


def dryrun_table(rows, mesh: str) -> str:
    out = ["| arch | shape | status | plan | peak mem/rank | args/rank | FLOPs/rank "
           "| bytes/rank | collective bytes/rank | B1 launches |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or not _default(r):
            continue
        if r.get("status") == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP ({r['reason'][:40]}…) "
                       "| - | - | - | - | - | - | - |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | - | - | - | - | - | - | - |")
            continue
        launches = sum(r.get("kernel_launches", {}).values())
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['plan_s']}s "
            f"| {fmt_bytes(r.get('peak_memory_in_bytes'))} "
            f"| {fmt_bytes(r.get('argument_size_in_bytes'))} "
            f"| {r['flops']:.2e} | {fmt_bytes(r['bytes_accessed'])} "
            f"| {fmt_bytes(r['collectives']['total'])} | {launches} |")
    return "\n".join(out)


def roofline_table(rows, mesh: str = "single") -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | MODEL_FLOPS/chip "
           "| useful ratio |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or r.get("status") != "ok" or not _default(r):
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {format_seconds(r['compute_s'])} | {format_seconds(r['memory_s'])} "
            f"| {format_seconds(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['model_flops_per_chip']:.2e} | {r['useful_flops_ratio']:.2f} |")
    return "\n".join(out)


def summary_table(rows) -> str:
    """One row an (arch, shape): both meshes' peaks, the single mesh's
    counts and roofline terms (the compact form PERF.md carries)."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows if _default(r)}
    out = ["| arch | shape | peak/rank single; multi | FLOPs/rank | bytes/rank | coll. bytes/rank "
           "| B1 | compute | memory | collective | dominant | useful |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch, shape in sorted({(a, s) for a, s, _ in by}):
        r, m = by.get((arch, shape, "single"), {}), by.get((arch, shape, "multi"), {})
        if r.get("status") != "ok":
            out.append(f"| {arch} | {shape} | {r.get('status', 'missing').upper()} "
                       "| - | - | - | - | - | - | - | - | - |")
            continue
        out.append(
            f"| {arch} | {shape} | {fmt_bytes(r['peak_memory_in_bytes'])}; "
            f"{fmt_bytes(m.get('peak_memory_in_bytes'))} | {r['flops']:.2e} "
            f"| {fmt_bytes(r['bytes_accessed'])} | {fmt_bytes(r['collectives']['total'])} "
            f"| {sum(r['kernel_launches'].values())} | {format_seconds(r['compute_s'])} "
            f"| {format_seconds(r['memory_s'])} | {format_seconds(r['collective_s'])} "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.2f} |")
    return "\n".join(out)


def perf_table(paths, pairs) -> str:
    """Every recorded variant of the given (arch, shape) pairs, single mesh."""
    rows = []
    for p in paths:
        try:
            rows.extend(load(p))
        except FileNotFoundError:
            pass
    out = ["| arch | variant | compute | memory | collective | peak/rank | args/rank |",
           "|---|---|---|---|---|---|---|"]
    for arch, shape in pairs:
        sel = [r for r in rows if r.get("arch") == arch and r.get("shape") == shape
               and r.get("mesh") == "single" and r.get("status") == "ok"]
        sel.sort(key=lambda r: (r.get("param_mode", ""), r.get("strategy", ""),
                                r.get("attn_chunk", 0), r.get("seq_parallel", False),
                                r.get("device_steps", 1)))
        for r in sel:
            variant = f"{r.get('strategy', 'gather')}/{r.get('param_mode', 'replicated')}"
            if r.get("attn_chunk", 1024) != 1024:
                variant += f"/chunk{r['attn_chunk']}"
            if r.get("seq_parallel"):
                variant += "/seqpar"
            if r.get("device_steps", 1) != 1:
                variant += f"/ds{r['device_steps']}"
            out.append(
                f"| {arch} | {variant} | {format_seconds(r['compute_s'])} "
                f"| {format_seconds(r['memory_s'])} | {format_seconds(r['collective_s'])} "
                f"| {fmt_bytes(r.get('peak_memory_in_bytes'))} "
                f"| {fmt_bytes(r.get('argument_size_in_bytes'))} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="dryrun_torch_results.jsonl")
    ap.add_argument("--section", default="all",
                    choices=["dryrun", "roofline", "perf", "summary", "all"])
    args = ap.parse_args(argv)
    rows = load(args.inp)
    note = ("(per-rank counts of the port's dry-run; times from the H100 SXM data sheet at "
            "700 W: computed, not measured)")
    if args.section in ("perf", "all"):
        pairs = [("llama3.2-3b", "train_4k"), ("grok-1-314b", "train_4k"),
                 ("llama3-405b", "train_4k")]
        print(f"\n### Perf variants {note}\n")
        print(perf_table([args.inp], pairs))
    if args.section in ("dryrun", "all"):
        print(f"### Single mesh (data 16 × model 16 = 256 ranks) {note}\n")
        print(dryrun_table(rows, "single"))
        print(f"\n### Multi mesh (pod 2 × data 16 × model 16 = 512 ranks) {note}\n")
        print(dryrun_table(rows, "multi"))
    if args.section == "summary":
        print(f"### Dry-run and roofline, single mesh (multi's peak beside) {note}\n")
        print(summary_table(rows))
    if args.section in ("roofline", "all"):
        print(f"\n### Roofline (single mesh, per-rank terms) {note}\n")
        print(roofline_table(rows, "single"))


if __name__ == "__main__":
    main()
