"""The benchmark's plain reference of the serving path (float32, PyTorch).

Frozen copies of the port's input build, detectors and decode as they were
when the benchmark was written, with every hand kernel replaced by its plain
form: the SHPL pool (kernel A) by one f32 ``index_add_``, the grouped RPN crop
(kernel C) by its gather-and-matmul evaluation. Later changes to the port do
not reach these files, so the judge holds the port to what it computed here.
It imports torch and numpy only: nothing of the port, of JAX or of the JAX
package. ``pipeline.set_lower`` makes the control: the same reference with
every conv and dense layer rounded through float8.
"""
