"""Offline data tooling (reference utils/data/, python_scripts/clustering/),
the port of ``texttoaudiogrounding_tpu/tools/``: waveform packing, phrase
parsing, label manipulation, phrase-embedding extraction on the port's text
towers, clustering, phrase→event mapping and its BERTScore / BLEURT
backends.
"""
