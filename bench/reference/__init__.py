"""Plain references, one module per program (``configs/*.json``'s
``program``), in plain PyTorch on the inputs the benchmark made.  They
import nothing of ``repro_torch`` and take nothing it made: the
program's answers are only judged.  Each module has

* ``answer(columns)``: the query's answer, float64 words in the order
  of the program's output;
* ``errors(got, want)``: the compared numbers of one answer;
* ``ops(shapes)``: the operations the program's bodies do on inputs of
  these shapes (name -> shape), for the yardstick;
* ``control(**columns)``: the same query in the next precision below
  the configuration's (bfloat16 for float32), put in the program's
  place to show that the comparison fails it.
"""
