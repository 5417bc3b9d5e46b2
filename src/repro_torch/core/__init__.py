"""The parameterised quantised-execution core, on torch tensors
(counterpart of ``repro/core``): ``fixed_point`` (C1), ``hard_act`` (C2),
``qlstm`` (the model, float and integer datapaths) and ``accelerator``
(C4: Table-2 meta-parameters and the Hopper ``plan()``).  The energy
model waits for a later slice."""
