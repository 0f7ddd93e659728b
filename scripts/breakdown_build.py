"""Builds patched copies of one kernel source side by side, for the breakdown
scripts (`w4a16_breakdown.py`, `w4a8_breakdown.py`, `attention_breakdown.py`):
each variant is the source with some lines replaced, compiled with the
package's own nvcc flags into build/breakdown/."""
import os
import subprocess


def patch(src, name, patches):
    """`src` with each (old, new) of `patches` replaced; raises if the source
    no longer has an `old` (the patches name exact source lines)."""
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(build, source, make):
    """nvcc every variant of csrc/`source` at once: `make` maps a variant's name
    to a function of the source text that returns the variant's text. Returns
    name -> path of its shared library; raises with nvcc's log if one fails."""
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        src = f.read()
    stem = os.path.splitext(source)[0]
    out_dir = os.path.join(build.BUILD_DIR, "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = {}, {}
    for name, fn in make.items():
        cu = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(cu, "w") as f:
            f.write(fn(src))
        libs[name] = os.path.join(out_dir, f"{stem}_{name}.so")
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", libs[name], cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
    return libs
