"""crop2seg_tpu_torch.graft_entry on the CPU: ``dryrun_multichip(2,
device="cpu")`` runs every data-parallel and patch-parallel block of
__graft_entry__.py's dry run over two gloo processes, the two on the 2-D
(1, 2) data x space mesh too, and ``entry`` returns the flagship U-TAE's
forward at the JAX entry's shapes."""
import numpy as np

from crop2seg_tpu_torch.graft_entry import dryrun_multichip, entry


def test_dryrun_multichip_over_two_gloo_ranks(capfd):
    out = dryrun_multichip(2, device="cpu")
    assert np.isfinite([out["dp_loss"], out["pair_train_loss"], out["wtae_dp_loss"]]).all()
    printed = capfd.readouterr().out
    for name, line in (("dp_sp_losses", "dp x sp loss="),
                       ("pair_sp_losses", "pallas-train pool on data x space mesh loss=")):
        one, two, dropped = out[name]             # 1-D and 2-D at dropout 0, 2-D with it
        assert abs(two - one) < 1e-3 and np.isfinite(dropped)
        assert any(line in ln and ln.endswith("OK") for ln in printed.splitlines()), printed
    assert "waits" not in printed
    ev = out["eval_loss"]
    assert abs(ev["pair"] - ev["plain"]) < 1e-4 * max(1.0, abs(ev["plain"]))
    direct, resumed = out["resume_loss"]
    assert abs(direct - resumed) < 1e-6


def test_entry_builds_the_flagship_forward():
    fn, args = entry(device="cpu")
    x, dates, pad_mask = args
    assert x.shape == (1, 30, 128, 128, 10) and dates.shape == (1, 30)
    assert pad_mask.sum().item() == 3                # length 27 of 30
    assert callable(fn)
