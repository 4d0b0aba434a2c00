"""Execute every demo notebook in place, committing outputs + figures.

The reference's notebooks are *executed documents* — their figures are the
de-facto gallery (reference: demos/gibbs_sampling_demo.ipynb ships ~400 KB
of executed cells). This script brings the rebuild's notebooks to the same
state, and the slow-tier test ``tests/test_notebooks.py`` keeps them
executable in CI.

The kernel subprocess must select the CPU backend *before* jax
initialises (a kernel that took the GPU would reserve most of its memory
beside any other JAX process on the card) — a temporary
``sitecustomize`` on the kernel's PYTHONPATH does this without touching
the notebooks.

Usage: python demos/execute_notebooks.py [notebook.ipynb ...]
"""

import os
import sys
import tempfile

import nbformat
from nbclient import NotebookClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SITECUSTOMIZE = """\
import os
# silence XLA slow-constant-folding alarms (stderr would otherwise land
# in the committed cell outputs)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
import jax
jax.config.update("jax_platforms", "cpu")
"""


def execute(path: str, timeout: int = 1200) -> None:
    nb = nbformat.read(path, as_version=4)
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "sitecustomize.py"), "w") as f:
            f.write(_SITECUSTOMIZE)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [td, REPO] + env.get("PYTHONPATH", "").split(os.pathsep)
        ).rstrip(os.pathsep)
        # no MPLBACKEND override: ipykernel's inline backend must stay
        # active so plt.show() captures figures as cell outputs
        client = NotebookClient(
            nb,
            timeout=timeout,
            kernel_name="python3",
            resources={"metadata": {"path": os.path.dirname(path) or "."}},
        )
        # the kernel subprocess inherits the parent's environment, so the
        # PYTHONPATH/sitecustomize forcing is delivered by mutating
        # os.environ around execute() — do NOT remove this in favour of a
        # kernel-manager kwarg without verifying the env actually reaches
        # the kernel (a notebook that initialises the GPU backend would
        # take most of the card's memory)
        os_environ_backup = dict(os.environ)
        os.environ.update(env)
        try:
            client.execute()
        finally:
            os.environ.clear()
            os.environ.update(os_environ_backup)
    _strip_compiler_noise(nb)
    nbformat.write(nb, path)


_NOISE_MARKERS = (
    "slow_operation_alarm",
    "Constant folding an instruction is taking",
    "If you'd like to file a bug",
    "This isn't necessarily a bug",
)


def _strip_compiler_noise(nb) -> None:
    """Drop XLA compiler-alarm chatter (slow constant-folding warnings on
    stderr) from stream outputs — compile-time diagnostics, not results;
    committed documents should show the computation's actual output."""
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        kept = []
        for out in cell.get("outputs", []):
            # only stderr streams: compiler alarms never land on stdout, and
            # restricting keeps genuine printed results in mixed cells safe
            if (
                out.get("output_type") == "stream"
                and out.get("name") == "stderr"
                and any(m in out.get("text", "") for m in _NOISE_MARKERS)
            ):
                import re

                # glog-stamped lines (E0817 12:34:56...), dumped HLO
                # instructions, and the alarm's own timing/precision chatter
                drop = re.compile(
                    r"^(E\d{4} \d{2}:\d{2}:\d{2}|\s*%|\s*ROOT )"
                    r"|operand_precision=|The operation took"
                )
                lines = [
                    ln
                    for ln in out["text"].splitlines(keepends=True)
                    if not any(m in ln for m in _NOISE_MARKERS)
                    and not drop.search(ln)
                ]
                text = "".join(lines).strip("\n")
                if not text.strip():
                    continue
                out["text"] = text + "\n"
            kept.append(out)
        cell["outputs"] = kept


def main():
    targets = sys.argv[1:]
    if not targets:
        demo_dir = os.path.join(REPO, "demos")
        targets = sorted(
            os.path.join(demo_dir, f)
            for f in os.listdir(demo_dir)
            if f.endswith(".ipynb")
        )
    for t in targets:
        print(f"[ executing {os.path.basename(t)} ]", flush=True)
        execute(t)
        print(f"[ done      {os.path.basename(t)} ]", flush=True)


if __name__ == "__main__":
    main()
