"""Count the SASS instructions of the port's elementwise kernels.

For each tree given (a directory holding ``src/repro_torch``), a child
process builds that tree's kernels (``kernels/_build.py``), and
``cuobjdump -sass`` disassembles the library. For every instantiation of
the kernels named in ``KERNELS`` the script counts, statically:

  * ``instructions``: the instructions a thread can issue, without the
    slow paths that IEEE division and square root take only for operands
    out of their fast range (each called subroutine, from its address to
    its first ``RET``, and the call site a predicated branch jumps over),
    without ``NOP`` and the closing self-branch;
  * ``mufu``: how many of those run on the special-function unit
    (``MUFU.*``: ex2, rcp, rsq, ...), by kind;
  * ``loops``: for each backward branch, the instructions and MUFU ops
    between its target and itself (a loop's body, issued once an
    iteration).

Both sides of an if/else count in ``instructions``: a warp whose threads
take both issues both. A kernel without loops issues ``instructions`` a
thread; one with a grid-stride loop issues its loop's count an iteration
(``calls`` counts the slow-path call sites left out). These counts are
what ``chip_smoke.py`` divides by the card's issue rate (132 SMs x 128
lanes a clock) and special-function rate (132 x 16 a clock) for its
bounds of the activation and max-pool kernels.

Usage, on the card (``nvcc`` and ``cuobjdump`` under /usr/local/cuda)::

    python3 tools/sass_counts.py build/ab/parent build/ab/change

One JSON line a tree on stdout; the full listing of each counted kernel
goes to ``chiprun_out/sass_<tree>.txt``, which ``--listing`` counts again
anywhere: ``python3 tools/sass_counts.py --listing chiprun_out/sass_*.txt``.
"""
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("pfp_activation_kernel", "pfp_maxpool2d_kernel",
           "pfp_empty_kernel")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _tool(name):
    found = shutil.which(name)
    if found:
        return found
    path = Path("/usr/local/cuda/bin") / name
    if path.exists():
        return str(path)
    raise RuntimeError(f"{name} not found")


def functions(sass):
    """{mangled name: [(addr, text)]} of a cuobjdump listing."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        if current is None:
            continue
        m = _INSTR.search(line)
        if m:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _target(text):
    """The address a BRA or CALL jumps to (cuobjdump prints it last)."""
    m = re.search(r"(0x[0-9a-f]+)\s*$", text)
    return int(m.group(1), 16) if m else None


def count(lines):
    """The counts described in the module docstring for one function."""
    instrs = [(addr, text) for addr, text in lines if addr is not None]
    opcode = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for _, t in instrs]
    addrs = [a for a, _ in instrs]
    calls = [a for a, op in zip(addrs, opcode) if op.startswith("CALL")]
    skip = set()
    # Slow-path subroutines: from each CALL's target to the first RET.
    for (_, text), op in zip(instrs, opcode):
        if op.startswith("CALL"):
            start = _target(text)
            for a, o in zip(addrs, opcode):
                if a >= start:
                    skip.add(a)
                    if o.startswith("RET"):
                        break
    # Their call sites: what a predicated forward branch jumps over when
    # the range holds a CALL and nothing but the call's moves and branches.
    setup = ("MOV", "IMAD.MOV", "CALL", "BRA")
    for (a, text), op in zip(instrs, opcode):
        t = _target(text) if op == "BRA" and text.startswith("@") else None
        if t is None or t <= a or not any(a < c < t for c in calls):
            continue
        inside = [o for x, o in zip(addrs, opcode) if a < x < t]
        if all(o.startswith(setup) for o in inside):
            skip.update(x for x in addrs if a < x < t)
    body, loops = [], []
    for (addr, text), op in zip(instrs, opcode):
        if addr in skip or op == "NOP":
            continue
        t = _target(text) if op == "BRA" else None
        if t == addr:
            continue                     # the closing self-branch
        body.append((addr, op))
        if t is not None and t < addr:
            loops.append((t, addr))

    def tally(ops):
        mufu = Counter(op for op in ops if op.startswith("MUFU"))
        return {"instructions": len(ops), "mufu": sum(mufu.values()),
                "mufu_by_kind": dict(sorted(mufu.items()))}

    return {**tally([op for _, op in body]),
            "calls": len(calls),
            "loops": [{"from": hex(a), "to": hex(b),
                       **tally([op for addr, op in body if a <= addr <= b])}
                      for a, b in loops]}


def read_listing(path):
    """{name: lines} of a listing this script wrote (``sass_<tree>.txt``),
    to count again without the card."""
    out, current = {}, None
    for line in Path(path).read_text().splitlines():
        if line.startswith("== "):
            current = out.setdefault(line[3:], [])
        elif current is not None and re.match(r"[0-9a-f]{5} ", line):
            current.append((int(line[:5], 16), line[6:]))
    return out


def demangle(names):
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return dict(zip(names, out.stdout.splitlines()))
    except (RuntimeError, subprocess.CalledProcessError):
        return {n: n for n in names}


def child(tree):
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import _build
    _build.load()
    print(Path(_build.BUILD_INFO["directory"]) / _build.LIB_NAME)


def main(trees):
    if not trees:
        print(__doc__)
        return 1
    if trees[0] == "--listing":
        for path in trees[1:]:
            print(json.dumps({"listing": path, "counts": {
                name: count(lines)
                for name, lines in read_listing(path).items()}}))
        return 0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for tree in trees:
        lib = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True, check=True
                             ).stdout.strip().splitlines()[-1]
        sass = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {name: lines for name, lines in functions(sass).items()
                 if any(k in name for k in KERNELS)}
        names = demangle(sorted(funcs))
        listing = []
        counts = {}
        for name in sorted(funcs):
            counts[names[name]] = count(funcs[name])
            listing.append(f"== {names[name]}\n" + "\n".join(
                f"{a:05x} {t}" for a, t in funcs[name]))
        (out_dir / f"sass_{Path(tree).resolve().name}.txt").write_text(
            "\n".join(listing))
        print(json.dumps({"tree": tree, "counts": counts}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
