"""The plain reference that decides each cell's `correct`.

`port/` is a frozen copy of the modules of `neurad_tpu_torch` that a camera
render and a training step of NeuRAD or SplatAD reach (the port at the
benchmark's first commit), its imports pointed at this copy and its kernel
dispatch removed: every hash-grid lookup and tile composite takes its plain
version in PyTorch. `port/precision.py` adds the fp8 operands of a control.
The modules beside it render a request (`neurad_serve.py`,
`splatad_serve.py`) or take a training step (`neurad_train.py`, its batch
drawn again from the sampler's state and built from the scene) from the
benchmark's own inputs (the scene that `port/data/dataparsers/synthetic.py`
draws, the weights that `portbench/harness/weights.py` draws from the seed),
in float32 with TF32 off. Nothing here imports the port, JAX or the JAX
package.

Because the copy is the port's own code, a fault that the port had when it
was made would be in the reference too: `portbench/tests/test_portbench_witness.py`
holds these modules against the JAX package, which shares no code with the
port, on the CPU.
"""
