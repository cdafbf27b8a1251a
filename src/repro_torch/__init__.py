"""PyTorch/CUDA port of the reference package ``repro``, for the NVIDIA
H100.  It imports ``torch`` and nothing of ``repro`` or JAX; each module
keeps its own copy of what it needs, at the same relative path as its
counterpart.  Ported so far: paged continuous-batching greedy decode of
dense GQA decoders (llama3.2-1b), on two hand-written CUDA kernels, and
dense continuous-batching serving of Mamba-2 (mamba2-370m), whose
prefill runs the SSD chunked scan as a hand-written CUDA kernel."""
