"""Local client training of the port: functional optimizers, the masked
local trainer and the evaluation loop."""

from fedml_tpu_torch.trainer.local import (LocalTrain, ModelFns, NetState,
                                           make_client_optimizer,
                                           make_eval_fn, make_local_train_fn,
                                           model_fns, seq_softmax_ce,
                                           softmax_ce)

__all__ = ["LocalTrain", "ModelFns", "NetState", "make_client_optimizer",
           "make_eval_fn", "make_local_train_fn", "model_fns",
           "seq_softmax_ce", "softmax_ce"]
