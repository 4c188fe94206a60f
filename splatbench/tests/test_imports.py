"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys

from splatbench.tests.tiny import REPO

CODE = """
import sys, pathlib, importlib
root = pathlib.Path('splatbench')
for path in sorted(root.rglob('*.py')):
    if 'tests' in path.parts:
        continue
    if path.parent.name == 'metrics':
        from splatbench import spec
        spec.reader(path.stem)
    else:
        importlib.import_module('.'.join(path.with_suffix('').parts).removesuffix('.__init__'))
import gsplat_tpu_torch, gsplat_tpu_torch.render.pipeline, gsplat_tpu_torch.kernels.raster
tops = {m.split('.')[0] for m in sys.modules}
assert 'gsplat_tpu_torch' in tops
bad = sorted(tops & {'jax', 'jaxlib', 'flax', 'gsplat_tpu'})
print(bad)
sys.exit(1 if bad else 0)
"""


def test_no_jax_and_no_jax_package_loaded():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
