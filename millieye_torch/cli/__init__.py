"""Command-line entry points (port of ``millieye_tpu/cli``); each takes
``--device`` where it touches the card, except ``prepare_data``, which
is host code.

python -m millieye_torch.cli.train        (module*/train.py)
python -m millieye_torch.cli.evaluate     (test_mixed / test_module2 /
                                           test_fusion)
python -m millieye_torch.cli.export       (a torch.export artifact)
python -m millieye_torch.cli.demo         (run_sp.py / run_mp.py)
python -m millieye_torch.cli.realtime     (realtime_show.py, live)
python -m millieye_torch.cli.collect      (data_collection/collect.py)
python -m millieye_torch.cli.prepare_data (data_collection/prepare_data.py)
"""
