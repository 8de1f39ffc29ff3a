"""The float64 numpy reference the evaluation scores with. Of the JAX
package's ``reference_cpu`` only the rotated IoU is ported so far; the CPU
reference pipeline (pillarizer, torch-CPU model, numpy NMS) is not."""
