"""The port's distributed control plane (counterpart:
``paddle_tpu.distributed``): the membership ``TCPStore`` over
``native/store/tcp_store.cpp`` (``store``), the injectable clock and
transport seam (``substrate``) and the checkpoint digest gate
(``elastic.verify_checkpoint``). The data plane (collectives, sharding,
pipelines) is still to port (ROADMAP A7)."""
