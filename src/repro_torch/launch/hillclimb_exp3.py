"""exp3 (qwen3-moe gossip communication) — gossip phase only: the global
phase is identical across variants except for the mixing op, so running
the gossip step per variant isolates exactly the quantity under test
(counterpart of ``repro/launch/hillclimb_exp3.py``; meta tensors, no card,
no JAX).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb_exp3
"""
from repro_torch.launch.hillclimb import OUT, exp3_qwen3moe_comm
from repro_torch.launch.mesh import make_production_mesh


def main() -> None:
    mesh = make_production_mesh(multi_pod=False, device="meta")
    exp3_qwen3moe_comm(mesh, OUT, phases=("gossip",))


if __name__ == "__main__":
    main()
