"""The static-graph surface of the port (``paddle_tpu.static``): record a
Program with ``static.data`` under ``program_guard`` (from the port's
``nn`` modules and functionals, or from ``static.nn``), add the backward
and the updates with ``append_backward`` / ``Optimizer.minimize``,
rewrite it with ``apply_pass`` / ``apply_build_strategy`` (which fuse
linear -> activation pairs into the ``fused_linear`` kernel), and run it
with ``Executor``.  Design notes in ``graph.py``.

    from paddle_tpu_torch import static
    static.enable_static()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 16])
        loss = static.nn.fc(x, 32, activation="gelu", device="cpu").mean()
    static.apply_build_strategy(main, keep=[loss.name])
    exe = static.Executor("cpu")
    exe.run(startup)
    (out,) = exe.run(main, feed={"x": xv}, fetch_list=[loss])
"""
from . import nn
from .graph import (Executor, OpDesc, Parameter, Program, Scope, Variable,
                    append_backward, cond, create_parameter, data,
                    default_main_program, default_startup_program,
                    disable_static, enable_static, global_scope, gradients,
                    in_static_mode, load_inference_model, program_guard,
                    record_writeback_op, save_inference_model, switch_case,
                    while_loop)
from .passes import (apply_build_strategy, apply_pass, get_pass, list_passes,
                     register_pass)

__all__ = ["Executor", "OpDesc", "Parameter", "Program", "Scope",
           "Variable", "append_backward", "apply_build_strategy",
           "apply_pass", "cond", "create_parameter", "data",
           "default_main_program", "default_startup_program",
           "disable_static", "enable_static", "get_pass", "global_scope",
           "gradients", "in_static_mode", "list_passes",
           "load_inference_model", "nn", "program_guard",
           "record_writeback_op", "register_pass", "save_inference_model",
           "switch_case", "while_loop"]
