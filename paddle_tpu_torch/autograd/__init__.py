"""The autograd surface (counterpart: ``paddle_tpu/autograd/``) over
PyTorch's engine: there is no second tape. ``register_grad_ready_hook``
is the seam ``DataParallel``'s bucketed gradient sync hangs on;
``deferred_leaf_grads`` (``tape.py``) splits a backward into the walk and
the deferred accumulation of matching leaves, the zero-bubble pipeline's
B/W split."""
from .grad_mode import no_grad, enable_grad, is_grad_enabled, set_grad_enabled
from .tape import (backward, deferred_leaf_grads, register_grad_ready_hook,
                   register_post_backward_hook)
from .py_layer import PyLayer, PyLayerContext
from .functional import grad, vjp, jvp, jacobian, hessian
