"""The operand orders of XLA's copies in ``k_big``, read off its own object
code, against ``polar_torch.probes.BIG_COPIES``.

    JAX_PLATFORMS=cpu python tests/xla_copy_orders.py DUMP_DIR

runs the script's ``k_big`` (``benchmarks/probe_r4.py``, taken from its
source as ``test_torch_probes`` takes it) at [64, 512] in interpret mode on
the CPU, with and without its loop, each in a process of its own with
``XLA_FLAGS=--xla_dump_to=DUMP_DIR/<probe>``, and reads the dump: the
optimised HLO (``*cpu_after_optimizations.txt``) names each fusion that
computes a stage's rolled partner array (``slice_concatenate_fusion``: the
roll's distance 2^s gives the stage s, the order of its two slices the
side), and ``objdump -d`` of that fusion's object file gives, in its vector
loops (``vmulps`` on ``ymm`` registers), the first source of each multiply:
on x86 the NaN a product keeps when both sources are NaNs. A fusion
computes the partner's value again from the scratch through stages
0..s-1, two multiplies a stage, for each of its two slices; a stage's two
letters are the first product's first source (``s``: sign(xx), ``m``: the
minimum of the magnitudes) and the second's (``t``: the first product,
``p``: sign(part)). So ``st`` is stage 0's order (``_minsum(..., True,
False)``), ``mp`` every later stage's (``False, True``) and ``sp`` the copy
order (``True, True``). Prints one JSON line a fusion and exits non-zero
where the code and ``BIG_COPIES`` disagree. The stage-7 partner is computed
inside the final fusion and cannot show in an output (``csrc/probes.cuh``
says why); it is not read. Needs ``objdump`` (GNU binutils).
"""

import glob
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from polar_torch import probes  # noqa: E402

NAMES = {"bigsweep": 4, "bigsweep_noloop": 1}
ORDER = {probes.MAIN: "st", probes.ALT: "sp"}   # stage 0 of each chain
INS = re.compile(r"^\s*[0-9a-f]+:\s+(\S+)\s+(.*)$")


def run_kernel(name):
    """The script's kernel ``name`` on the pairs input, in interpret mode
    (in the child process that XLA dumps)."""
    import jax.numpy as jnp
    import test_torch_probes as t
    x = probes.pair_input(0)
    t._jax_mini(t._script_kernels(), name, jnp.asarray(x.numpy()))


def fusion_stages(hlo):
    """{fusion name: (stage, side)} of the partner-array fusions of the
    optimised HLO text ``hlo``."""
    comps, calls = {}, {}
    for block in re.split(r"\n(?=%\S+ \()", hlo):
        head = block.split(" ", 1)[0].lstrip("%")
        comps[head] = block
    for m in re.finditer(r"%(slice_concatenate_fusion[.\d]*) = .*?"
                         r"calls=%([\w.]+)", hlo):
        calls[m.group(1)] = m.group(2)
    out = {}
    for fusion, comp in calls.items():
        body = comps[comp]
        root = re.search(r"ROOT .*concatenate\(%([\w.]+),", body).group(1)
        start = int(re.search(re.escape(f"%{root} = ") + r".*?slice="
                              r"\{\[(\d+):", body).group(1))
        side, d = ("A", start) if start < 512 else ("B", 1024 - start)
        out[fusion] = (d.bit_length() - 1, side)
    return out


def vector_orders(obj):
    """The first source of each ``vmulps`` on ``ymm`` registers in object
    file ``obj``: ``m`` the minimum, ``t`` a product, ``s`` anything else
    (a sign), following each register's last writer in program order."""
    text = subprocess.run(["objdump", "-d", "--no-show-raw-insn", obj],
                          capture_output=True, text=True, check=True).stdout
    tag, seq = {}, []
    for line in text.splitlines():
        m = INS.match(line)
        if not m:
            continue
        op, args = m.groups()
        regs = re.findall(r"%([xyz]mm\d+)", args)
        if not regs or "(" in args.split(",")[-1]:
            continue                      # no register written
        dst = regs[-1]
        if op.startswith(("vmins", "vminp")):
            tag[dst] = "m"
        elif op.startswith(("vmuls", "vmulp")):
            if "ymm" in args:
                seq.append(tag.get(regs[-2], "s"))
            tag[dst] = "t"
        elif not ("{%k" in args and "{z}" not in args
                  and tag.get(dst) == "m"):
            tag[dst] = "s"                # (not the minimum's NaN fix-up)
    return seq


def expected(stage, sweeps):
    """The orders of stages 0..stage-1 of the copy ``BIG_COPIES`` names
    for the stage-``stage`` partner."""
    copy = probes.BIG_COPIES[sweeps][stage]
    steps = [ORDER[probes.MAIN if copy == probes.MAIN else probes.ALT]]
    steps += ["mp"] * (stage - 1)
    if copy == probes.ALT_LAST:
        steps[-1] = "sp"
    return steps


def read(name, root):
    """One row a partner fusion of probe ``name``'s dump under ``root``."""
    (hlo_file,) = [f for f in glob.glob(os.path.join(
        root, "*cpu_after_optimizations.txt"))
        if "slice_concatenate_fusion" in open(f).read()]
    module = os.path.basename(hlo_file).split(".cpu_after")[0]
    rows = []
    for fusion, (stage, side) in sorted(
            fusion_stages(open(hlo_file).read()).items(),
            key=lambda kv: kv[1]):
        if stage == 0:
            continue                      # the scratch, rolled: no product
        obj = os.path.join(root, f"{module}.obj-file.{fusion}"
                                 "_kernel_module.o")
        seq = vector_orders(obj)
        # two multiplies a stage, stages 0..stage-1, once a slice
        steps = [("m" if seq[i] == "m" else "s")
                 + ("t" if seq[i + 1] == "t" else "p")
                 for i in range(0, len(seq), 2)]
        copies = [steps[i:i + stage] for i in range(0, len(steps), stage)]
        want = expected(stage, NAMES[name])
        rows.append({"probe": name, "fusion": fusion, "stage": stage,
                     "side": side, "orders": copies[0],
                     "copies_agree": all(c == copies[0] for c in copies),
                     "table": want, "match": all(c == want for c in copies)})
    return rows


def main(argv):
    if argv[:1] == ["--run"]:
        run_kernel(argv[1])
        return 0
    out = os.path.abspath(argv[0])
    ok = True
    for name in NAMES:
        root = os.path.join(out, name)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_dump_to={root} --xla_dump_hlo_as_text")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                        name], env=env, check=True)
        for row in read(name, root):
            print(json.dumps(row))
            ok &= row["match"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
