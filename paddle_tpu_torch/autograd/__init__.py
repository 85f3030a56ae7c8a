"""The autograd surface (counterpart: ``paddle_tpu/autograd/``) over
PyTorch's engine: there is no second tape. ``register_grad_ready_hook``
is the seam ``DataParallel``'s bucketed gradient sync hangs on. The
reference's ``deferred_leaf_grads`` (the zero-bubble pipeline's B/W
split) has no counterpart here; it waits for the pipeline's slice
(ROADMAP A7)."""
from .grad_mode import no_grad, enable_grad, is_grad_enabled, set_grad_enabled
from .tape import (backward, register_grad_ready_hook,
                   register_post_backward_hook)
from .py_layer import PyLayer, PyLayerContext
from .functional import grad, vjp, jvp, jacobian, hessian
