"""Recurrent cells: dense RNN/LSTM/GRU and conv CRNN/CLSTM/CGRU (NCHW).

The dense cells are torch's own ``nn.{RNN,LSTM,GRU}Cell``: eve_tpu
reproduces their gate math and parameter layout (``weight_ih``,
``weight_hh``, ``bias_ih``, ``bias_hh``), so the reference checkpoints map
1:1. The conv cells are the reference's ``CRNNCell``/``CLSTMCell``/
``CGRUCell``: 3x3 convolutions over the channel concatenation ``[x, h]``.

Every cell maps ``(x, state) -> (output, new_state)``; the LSTM cells carry
``(h, c)`` tuples. A conv cell computes in its input's type (its
convolutions cast their parameters to it), so bfloat16 states and input
keep it in bfloat16; the dense cells run float32.
"""

import torch
import torch.nn as nn

from eve_tpu_torch.models.layers import Conv2d, cat_channels


class RNNCell(nn.RNNCell):
    """h' = tanh(W_ih x + b_ih + W_hh h + b_hh)."""
    tuple_state = False

    def forward(self, x, h):
        new_h = super().forward(x, h)
        return new_h, new_h


class GRUCell(nn.GRUCell):
    """torch GRU cell (r, z, n gate order)."""
    tuple_state = False

    def forward(self, x, h):
        new_h = super().forward(x, h)
        return new_h, new_h


class LSTMCell(nn.LSTMCell):
    """torch LSTM cell (i, f, g, o gate order)."""
    tuple_state = True

    def forward(self, x, state):
        new_h, new_c = super().forward(x, state)
        return new_h, (new_h, new_c)


class ConvRNNCell(nn.Module):
    """h' = tanh(conv3x3([x, h]))."""
    tuple_state = False

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.hidden_size = hidden_size
        self.cell = Conv2d(input_size + hidden_size, hidden_size, 3, 1, 1)

    def forward(self, x, h):
        new_h = torch.tanh(self.cell(cat_channels([x, h])))
        return new_h, new_h


class ConvLSTMCell(nn.Module):
    """4-gate conv LSTM; gate order i, f, o, g (not nn.LSTMCell's)."""
    tuple_state = True

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.hidden_size = hidden_size
        self.gates = Conv2d(input_size + hidden_size, 4 * hidden_size,
                            3, 1, 1)

    def forward(self, x, state):
        h, c = state
        gates = self.gates(cat_channels([x, h]))
        in_gate, forget_gate, out_gate, cell_gate = gates.chunk(4, dim=1)
        new_c = (torch.sigmoid(forget_gate) * c +
                 torch.sigmoid(in_gate) * torch.tanh(cell_gate))
        new_h = torch.sigmoid(out_gate) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class ConvGRUCell(nn.Module):
    """2+1-gate conv GRU; the output gate concatenates ``[reset*h, x]``."""
    tuple_state = False

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.hidden_size = hidden_size
        self.gates_1 = Conv2d(input_size + hidden_size, 2 * hidden_size,
                              3, 1, 1)
        self.gate_2 = Conv2d(input_size + hidden_size, hidden_size, 3, 1, 1)

    def forward(self, x, h):
        reset, update = torch.sigmoid(
            self.gates_1(cat_channels([x, h]))).chunk(2, dim=1)
        output = torch.tanh(self.gate_2(cat_channels([reset * h, x])))
        new_h = (1.0 - update) * output + update * h
        return new_h, new_h


DENSE_CELLS = {'RNN': RNNCell, 'LSTM': LSTMCell, 'GRU': GRUCell}
CONV_CELLS = {'CRNN': ConvRNNCell, 'CLSTM': ConvLSTMCell, 'CGRU': ConvGRUCell}


def zero_state(cell_cls, hidden_size, batch_size, hw=None, device=None,
               dtype=torch.float32):
    """Zero initial state for a cell class: (B, C) or (B, C, H, W), of the
    caller's ``dtype`` (the conv cells': the network's compute type)."""
    shape = ((batch_size, hidden_size) if hw is None
             else (batch_size, hidden_size, hw[0], hw[1]))
    z = torch.zeros(shape, dtype=dtype, device=device)
    return (z, z.clone()) if cell_cls.tuple_state else z
