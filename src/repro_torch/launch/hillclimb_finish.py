"""Resume helper: the last exp2 variant + exp3 + exp4 (counterpart of
``repro/launch/hillclimb_finish.py``; meta tensors, no card, no JAX).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb_finish
"""
from repro_torch.launch.hillclimb import (OUT, exp2_jamba_train,
                                          exp3_qwen3moe_comm,
                                          exp4_jamba_microbatch)
from repro_torch.launch.mesh import make_production_mesh


def main() -> None:
    mesh = make_production_mesh(multi_pod=False, device="meta")
    exp2_jamba_train(mesh, OUT, variants=("scan_bf16+one_peer_bf16_comm",))
    exp3_qwen3moe_comm(mesh, OUT)
    exp4_jamba_microbatch(mesh, OUT)


if __name__ == "__main__":
    main()
