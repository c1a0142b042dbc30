"""Executes the interactive notebooks end-to-end (code cells in order).

The notebooks (generated by examples/make_notebooks.py) are the
framework's recipe documentation — the twins of the reference's
em_alignment and liconn_inplane_stitching notebooks — and double as
integration tests: their final cells assert alignment/stitching quality
and print PASS.
"""

import json
import os

import pytest

REPO = os.path.join(os.path.dirname(__file__), '..')
NOTEBOOKS = ['em_alignment.ipynb', 'liconn_inplane_stitching.ipynb']


@pytest.mark.parametrize('name', NOTEBOOKS)
def test_notebook_executes(name, monkeypatch):
  path = os.path.join(REPO, 'notebooks', name)
  monkeypatch.setenv('SOFIMA_NB_CPU', '1')
  monkeypatch.setenv('MPLBACKEND', 'Agg')
  with open(path) as f:
    nb = json.load(f)
  ns = {}
  for i, cell in enumerate(nb['cells']):
    if cell['cell_type'] != 'code':
      continue
    src = ''.join(cell['source'])
    exec(compile(src, f'{name}:cell{i}', 'exec'), ns)  # noqa: S102


def test_notebooks_in_sync_with_generator():
  """The committed .ipynb files match what the generator produces."""
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      'make_notebooks', os.path.join(REPO, 'examples/make_notebooks.py'))
  gen = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(gen)

  for name, cells in [('em_alignment.ipynb', gen.EM_CELLS),
                      ('liconn_inplane_stitching.ipynb', gen.LICONN_CELLS)]:
    with open(os.path.join(REPO, 'notebooks', name)) as f:
      nb = json.load(f)
    on_disk = [(c['cell_type'], ''.join(c['source'])) for c in nb['cells']]
    generated = [(c['cell_type'], ''.join(c['source'])) for c in cells]
    assert on_disk == generated, f'{name} is stale: rerun make_notebooks.py'
