"""Build variants of one kernel source, each with a few textual edits.

Shared by the ablation tools: ``build`` writes each variant of
``bayesic_tpu_torch/csrc/<source>`` (with the headers it includes) into its
own directory and compiles it alone into a shared library with the port's
nvcc flags, all nvcc processes at once.  An edit applies to the source and
to each header that holds its text; one whose text is in none of them
raises, so a tool that has fallen behind the kernel says so.
``build_parent`` compiles the same source of another checkout (the commit
before a redesign) alone, with its own headers.
"""

from __future__ import annotations

import subprocess
from pathlib import Path


def build(source, headers, variants, tmp):
    """``variants``: {name: {old text: new text}}; returns {name: (library
    path, ``chip_smoke._ptxas_summary`` of its nvcc output: registers and
    spills by kernel)}."""
    from bayesic_tpu_torch.ops import _build
    from chip_smoke import _ptxas_summary

    files = {f: (_build.CSRC / f).read_text() for f in [source, *headers]}
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = Path(tmp) / f"v{i}"
        d.mkdir()
        texts = dict(files)
        for old, new in edits.items():
            hit = [f for f, text in texts.items() if old in text]
            if not hit:
                raise RuntimeError(f"{name}: '{old[:80]}' not in {source} "
                                   f"or its headers")
            for f in hit:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (d / f).write_text(text)
        so = d / "lib.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(d / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        out[name] = (so, _ptxas_summary(log))
    return out


def build_parent(source, parent, tmp):
    """``bayesic_tpu_torch/csrc/<source>`` of the checkout ``parent`` (an
    unpacked ``git archive``) built alone into a library: (path,
    ``chip_smoke._ptxas_summary`` of its nvcc output)."""
    from bayesic_tpu_torch.ops import _build
    from chip_smoke import _ptxas_summary

    src = Path(parent) / "bayesic_tpu_torch" / "csrc" / source
    so = Path(tmp) / f"parent_{Path(source).stem}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(src)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"parent: nvcc failed\n{res.stdout}{res.stderr}")
    return so, _ptxas_summary(res.stdout + res.stderr)
