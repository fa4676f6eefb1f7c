"""Concurrent first builds of the kernels (`ops/kernels.py::build_library`).

Ranks that start together build the kernels at first use at the same time.
Here two processes call `build_library` at once into one empty build
directory, with a stand-in `nvcc` first on PATH: it writes each object in
two halves with a pause between them and links by writing the objects end
to end, so a build that reads or links another process's half-written
object leaves a library with a torn or mixed object. Both processes must
return the same library, holding every source's object whole and from one
process, and the build directory must hold that library and its log and
nothing else; a later call finds the library and runs no compiler.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

from ppsurf_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = 2000  # lines of each stand-in object

FAKE_NVCC = textwrap.dedent(f"""\
    #!{sys.executable}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-c" in args:  # compile: the object in two halves, a pause between
        src = os.path.basename(args[args.index("-c") + 1])
        body = f"object {{src}} of {{os.getpid()}}\\n" * {LINES}
        with open(out, "w") as fp:
            fp.write(body[: len(body) // 2])
            fp.flush()
            time.sleep(0.4)
            fp.write(body[len(body) // 2:])
    else:  # link: the objects end to end
        time.sleep(0.2)
        with open(out, "w") as fp:
            for obj in [a for a in args if a.endswith(".o")]:
                with open(obj) as src:
                    fp.write(src.read())
    print("ptxas info    : stand-in")
    """)

RANK = textwrap.dedent("""\
    import os, sys, time
    from ppsurf_tpu_torch.ops import kernels
    build_dir, ready, me = sys.argv[1], sys.argv[2], int(sys.argv[3])
    kernels.BUILD_DIR = build_dir
    open(os.path.join(ready, f"ready{me}"), "w").close()
    deadline = time.monotonic() + 120
    while len(os.listdir(ready)) < 2:  # start together
        if time.monotonic() > deadline:
            sys.exit("the other process never started")
        time.sleep(0.01)
    path, log = kernels.build_library()
    print(path)
    """)


def test_concurrent_first_builds_leave_one_whole_library(tmp_path, monkeypatch):
    bin_dir, build_dir, ready = tmp_path / "bin", tmp_path / "build", tmp_path / "ready"
    for d in (bin_dir, build_dir, ready):
        d.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(build_dir), str(ready), str(i)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip().splitlines()[-1] for out in outs}
    assert len(paths) == 1, outs
    lib = paths.pop()

    # the library: every source's object whole, and each from one process
    with open(lib) as fp:
        lines = fp.read().splitlines()
    assert len(lines) == LINES * len(kernels.SOURCES)
    for i, name in enumerate(kernels.SOURCES):
        part = set(lines[i * LINES:(i + 1) * LINES])
        assert len(part) == 1 and part.pop().startswith(f"object {name} of "), name

    # the build directory: the library and its log, no temporaries
    (digest,) = os.listdir(build_dir)
    assert sorted(os.listdir(build_dir / digest)) == ["build.log", "libppsurf_kernels.so"]
    assert "stand-in" in (build_dir / digest / "build.log").read_text()

    # a later build finds it and runs no compiler (none on PATH now)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("nvcc was run for a library on disk")))
    assert kernels.build_library()[0] == lib
