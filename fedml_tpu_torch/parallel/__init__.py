"""Client-parallel rounds of the port (one card, clients under vmap)."""

from fedml_tpu_torch.parallel.shard import (client_finite_mask, client_rngs,
                                            make_fused_round_step,
                                            make_vmap_round,
                                            run_clients_guarded)

__all__ = ["client_finite_mask", "client_rngs", "make_fused_round_step",
           "make_vmap_round", "run_clients_guarded"]
