"""The port stands alone: importing it loads neither JAX nor any module
of the JAX package, and no source file of the port (or the chip smoke
script) imports them."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_import_loads_no_jax_and_no_reference_module():
    # A subprocess: other test files in the same worker import jax.
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.kernels.ref, repro_torch.device\n"
        "import repro_torch.checkpoint, repro_torch.data.synthetic\n"
        "import repro_torch.core, repro_torch.core.codec\n"
        "import repro_torch.core.comm, repro_torch.core.exchange\n"
        "import repro_torch.core.ifl, repro_torch.core.report\n"
        "import repro_torch.core.rounds, repro_torch.api\n"
        "import repro_torch.api.schemes, repro_torch.api.spec\n"
        "import repro_torch.data.images, repro_torch.data.dirichlet\n"
        "import repro_torch.models.small, repro_torch.launch.quickstart\n"
        "import repro_torch.core.ifl_spmd, repro_torch.optim\n"
        "import repro_torch.train.loop, repro_torch.launch.train\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert len(files) > 10
    assert not offenders, offenders
