"""chip_smoke.py phases at a tiny size on the CPU (the card runs them full)."""

import json

import chip_smoke


def test_stack_phase():
  # 1280 px keeps the interior clear of the 320 px border margin, where
  # the unconstrained mesh edge dominates the error at smaller sizes.
  m = chip_smoke.phase_stack(n=1280, n_z=3)
  assert m['max_err'] <= 3.5 and not m['overflow']
  assert m['max_err'] < m['raw_err']


def test_ops_phase():
  m = chip_smoke.phase_ops(n=640, pair=400, mesh_n=24, render_rows=64)
  assert m['targeted_agree'] >= 0.999
  assert m['f32_flow_agree'] == 1.0


def test_montage_phase():
  m = chip_smoke.phase_montage(grid=2, tile=160, overlap=60, stride=20,
                               patch=40, coarse_overlaps=(55, 65),
                               min_overlap=10, margin=4, flow_batch=16)
  assert m['err'] <= 10.0 and m['coverage'] >= 0.95


def test_stitch3d_phase():
  m = chip_smoke.phase_stitch3d(depth=24, tile=48, overlap=16, stride=8,
                                patch=16, margin=4, flow_batch=8,
                                trim=(4, 8))
  assert m['rel_err'] <= 0.5 and m['coverage'] >= 0.5


def test_api_phase():
  assert chip_smoke.phase_api(n=1024)["ok"]


def test_multichip_phase():
  m = chip_smoke.phase_multichip(n=640, mesh_n=32)
  assert m['flow_sharded_agree'] == 1.0


def test_main_refuses_without_gpu(capsys):
  assert chip_smoke.main([]) != 0
  out = capsys.readouterr().out
  for line in out.splitlines():
    try:
      assert 'ok' not in json.loads(line)
    except json.JSONDecodeError:
      pass
