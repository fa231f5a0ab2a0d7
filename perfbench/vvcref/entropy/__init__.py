"""Entropy coding: CABAC engine (Python reference; C++ native backend in
native/), binarizers, and the CTU/CU/TU/residual syntax writer+parser."""
