"""The traffic generators are pure functions of the seed and the mix."""
import torch

from harness import traffic
from harness.common import load_cell
from harness.weights import make_weights, sub_seed


def test_sub_seed_is_stable_and_separates_streams():
    assert sub_seed(7, 1) == sub_seed(7, 1)
    assert len({sub_seed(7, 1), sub_seed(7, 2), sub_seed(8, 1)}) == 3
    assert 0 <= sub_seed(2 ** 40 + 3, 5) < 2 ** 63


def test_images_and_weights_are_functions_of_the_seed():
    cell = load_cell("protonets224.train_large")
    tr = dict(cell.traffic, shot=2, query_per_class=1, pool_batches=2)
    dev = torch.device("cpu")
    a = traffic.train_batches(torch, tr, 16, 3, 9, dev)
    b = traffic.train_batches(torch, tr, 16, 3, 9, dev)
    c = traffic.train_batches(torch, tr, 16, 3, 10, dev)
    assert torch.equal(a[1]["support_x"], b[1]["support_x"])
    assert not torch.equal(a[1]["support_x"], c[1]["support_x"])
    assert a[0]["support_x"].shape == (tr["tasks_per_step"], 20, 16, 16, 3)
    assert torch.equal(torch.sort(a[0]["support_y"][0]).values,
                       torch.arange(10).repeat_interleave(2))
    wa = make_weights(torch, cell.config, 9, dev)
    wb = make_weights(torch, cell.config, 9, dev)
    wc = make_weights(torch, cell.config, 10, dev)
    assert torch.equal(wa["bb"]["blocks"][3]["w"], wb["bb"]["blocks"][3]["w"])
    assert not torch.equal(wa["bb"]["blocks"][3]["w"], wc["bb"]["blocks"][3]["w"])
    assert torch.equal(traffic.h_scores(torch, 9, 4, (2, 5)), traffic.h_scores(torch, 9, 4, (2, 5)))
    assert not torch.equal(traffic.h_scores(torch, 9, 4, (2, 5)),
                           traffic.h_scores(torch, 9, 5, (2, 5)))


def test_weights_have_the_port_s_tree_and_initialiser_scale():
    cell = load_cell("protonets224.train_large")
    w = make_weights(torch, cell.config, 3, torch.device("cpu"))
    widths = cell.config["backbone"]["widths"]
    assert [b["w"].shape[0] for b in w["bb"]["blocks"]] == widths
    assert w["bb"]["head"]["w"].shape == (widths[-1], cell.config["backbone"]["feature_dim"])
    assert abs(float(w["bb"]["blocks"][1]["w"].std()) - (9 * widths[0]) ** -0.5) < 5e-3
    assert float(w["bb"]["blocks"][1]["b"].abs().max()) == 0.0
