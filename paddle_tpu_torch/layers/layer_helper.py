"""LayerHelper: shared machinery for layer functions.

Reference parity: paddle_tpu/layers/layer_helper.py (fluid
layer_helper.py): creates parameters in both the startup program (with
their init op) and the main program, appends ops, weaves bias and
activation, and infers output shapes through the op registry
(core/infer.py).
"""
import copy

from ..core import infer
from ..core.program import (Variable, default_main_program,
                            default_startup_program, unique_name)
from ..param_attr import ParamAttr

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get('name', None) is None:
            self.kwargs['name'] = unique_name(self.layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return self.kwargs.get('main_program') or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get('startup_program') or \
            default_startup_program()

    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('param_attr', None))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('bias_attr', None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        elif len(param_attr) == 1 and length != 1:
            param_attr = param_attr + [copy.deepcopy(param_attr[0])
                                       for _ in range(length - 1)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, param_attr in zip(inputs, param_attrs):
            yield ipt, param_attr

    def input_dtype(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError(
                    "Data Type mismatch: %s vs %s" % (dtype, each.dtype))
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, 'w' if not is_bias
                                              else 'b']))
        shape = [int(d) for d in shape]
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(attr.name):
            sp = startup_block.create_parameter(
                shape=shape, dtype=dtype, **attr.to_kwargs())
            attr.initializer(sp, startup_block)
        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            return main_block.var(attr.name)
        return main_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())

    def create_tmp_variable(self, dtype, shape=None, lod_level=0,
                            stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name(".".join([self.name, 'tmp'])),
            shape=shape or (),
            dtype=dtype,
            lod_level=lod_level,
            persistable=False,
            stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Give a non-parameter global var an init op in the startup
        program (optimizer state, learning rates)."""
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(var.name):
            sv = startup_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True)
            initializer(sv, startup_block)
        return var

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        """Append the op to the current block; with infer_shape, fill in
        the output variables' shapes and dtypes by running the op on
        meta tensors."""
        block = self.main_program.current_block()
        op = block.append_op(type=type, inputs=inputs, outputs=outputs,
                             attrs=attrs)
        if infer_shape:
            self._infer_shapes(block, op)
        return op

    def _infer_shapes(self, block, op):
        input_specs = {}
        for slot, names in op.inputs.items():
            specs = []
            for n in names:
                try:
                    v = block.var_recursive(n)
                    specs.append((v.shape, v.dtype))
                except KeyError:
                    specs.append(None)
            input_specs[slot] = specs
        try:
            outs = infer.infer_outputs(op.type, input_specs, op.attrs,
                                       list(op.outputs))
        except Exception:  # best effort, as the reference's build-time pass
            return
        for slot, names in op.outputs.items():
            for n, spec in zip(names, outs.get(slot, [])):
                if spec is None:
                    continue
                try:
                    v = block.var_recursive(n)
                except KeyError:
                    continue
                if v.persistable or v.is_data:
                    continue
                v.shape, v.dtype = spec

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b_dtype = 'float32' if str(input_var.dtype) in (
            'bfloat16', 'float16') else input_var.dtype
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=b_dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var], 'Y': [b]},
            outputs={'Out': [tmp]},
            attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act', None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop('type')
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(
            type=act_type,
            inputs={'X': [input_var]},
            outputs={'Out': [tmp]},
            attrs=act)
        return tmp
