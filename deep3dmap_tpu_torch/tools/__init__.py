"""Command-line entry points of the port, run as modules:

    python -m deep3dmap_tpu_torch.tools.train CONFIG [--device cpu] ...
    python -m deep3dmap_tpu_torch.tools.test CONFIG [--device cpu] ...
    python -m deep3dmap_tpu_torch.tools.data_gen_scannet --datapath D ...
    python -m deep3dmap_tpu_torch.tools.data_gen_prnet -i IN -o OUT [--synthetic-bfm]
    python -m deep3dmap_tpu_torch.tools.data_gen_multipie organize --labels L --out D
    python -m deep3dmap_tpu_torch.tools.import_weights KIND SRC DST.npz

and two for finding where time goes on the card:

    python -m deep3dmap_tpu_torch.tools.sample_stacks OUT.txt chip_smoke.py
    python -m deep3dmap_tpu_torch.tools.first_step_profile
"""
