"""The port's benchmark entry on the CPU: the JSON line through the CLI,
and the search stages at toy sizes (the card runs them at full size in
chip_smoke.py)."""

import json
import math

import torch

from dream_go_torch import bench, cli
from dream_go_torch.config import ModelConfig
from dream_go_torch.mcts.predictor import net_predictor
from dream_go_torch.models import tower as T

torch.set_num_threads(1)


def test_cli_bench_prints_the_json_line_on_cpu(capsys):
    assert cli.main(["--bench", "--device", "cpu", "--no-selfplay"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["metric"] == "env_steps_per_sec_per_chip"
    assert line["unit"] == "steps/s" and line["device"] == "cpu"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 100_000.0, 3)
    assert "mcts_sims_per_sec" not in line


def test_bench_search_stages_on_cpu():
    """The MCTS stage and the self-play stage (policy stagger, then the
    search run) with a 16 x 1 net, 4 boards, a 12-move game length.  The
    run ends at its second completion (the first flush, after 8 search
    moves), not at the window, so how fast the host is cannot change what
    it measures."""
    model = T.init_tower(ModelConfig(num_channels=16, num_blocks=1),
                         seed=0, device="cpu", dtype="float32")
    pred = net_predictor(model)
    assert bench.mcts_stage(pred, "cpu", batch=4, sims=2, reps=2) > 0
    out = bench.selfplay_stage(pred, "cpu", window_s=600.0, rollouts=4,
                               batch=4, max_moves=12, num_games=2)
    assert out["selfplay_batch"] == 4
    assert out["selfplay_rate_mode"] in ("completions",
                                         "extrapolated_moves_per_s")
    for key in ("selfplay_games_per_sec", "selfplay_sims_per_sec"):
        assert math.isfinite(out[key]) and out[key] > 0
