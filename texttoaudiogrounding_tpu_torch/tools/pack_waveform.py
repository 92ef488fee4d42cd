"""Pack audio files into float16 waveform HDF5 (+ TSV index).

Reference: utils/data/pack_waveform.py:36-103 (parallel decode + resample →
single or sharded HDF5, float16 storage).  Decoding uses scipy WAV reading
(uncompressed WAV only, no libsndfile); parallelism is a thread pool (decode releases
the GIL in scipy/NumPy).  A copy of ``texttoaudiogrounding_tpu/tools/
pack_waveform.py``, h5py and pandas imported where they are used.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from texttoaudiogrounding_tpu_torch.data.h5io import load_wav


def pack_waveform(wav_csv: str, output: str, sample_rate: int = 32000,
                  num_workers: int = 8, num_shards: int = 1) -> None:
    """``wav_csv``: TSV with audio_id / file_name columns."""
    import h5py
    import pandas as pd
    df = pd.read_csv(wav_csv, sep="\t")
    fname_col = "file_name" if "file_name" in df else "file_path"
    items = list(zip(df["audio_id"], df[fname_col]))
    output = Path(output)
    output.parent.mkdir(parents=True, exist_ok=True)

    def decode(args):
        audio_id, path = args
        try:
            wav = load_wav(str(path), sample_rate)
            return audio_id, wav.astype(np.float16)
        except Exception as exc:  # noqa: BLE001 - report & skip bad files
            print(f"skip {audio_id}: {exc}")
            return audio_id, None

    index_rows = []
    shards = []
    if num_shards == 1:
        shards = [h5py.File(output, "w")]
    else:
        for i in range(num_shards):
            shard_path = output.parent / f"{output.stem}_{i}{output.suffix}"
            shards.append(h5py.File(shard_path, "w"))
    try:
        with ThreadPoolExecutor(num_workers) as pool:
            for i, (audio_id, wav) in enumerate(pool.map(decode, items)):
                if wav is None:
                    continue
                hf = shards[i % num_shards]
                hf[audio_id] = wav
                index_rows.append({"audio_id": audio_id,
                                   "hdf5_path": str(
                                       Path(hf.filename).absolute())})
    finally:
        for hf in shards:
            hf.close()
    csv_path = output.with_suffix(".csv")
    pd.DataFrame(index_rows).to_csv(csv_path, sep="\t", index=False)
    print(f"packed {len(index_rows)} waveforms → {output} (+ {csv_path})")


def prepare_wav_csv(wav_dir: str, output: str) -> None:
    """Directory walk → ``audio_id<TAB>file_name`` TSV (reference
    utils/data/prepare_wav_csv.py:1-31)."""
    import pandas as pd
    rows = [{"audio_id": p.name, "file_name": str(p.absolute())}
            for p in sorted(Path(wav_dir).rglob("*.wav"))]
    pd.DataFrame(rows).to_csv(output, sep="\t", index=False)
    print(f"wrote {len(rows)} rows to {output}")


def prepare_duration(waveform_csv: str, output: str,
                     sample_rate: int = 32000) -> None:
    """Per-clip durations TSV from packed HDF5 lengths (reference
    utils/data/prepare_duration.py)."""
    import h5py
    import pandas as pd
    df = pd.read_csv(waveform_csv, sep="\t")
    rows = []
    cache: dict = {}
    for _, row in df.iterrows():
        path = row.get("hdf5_path", row.get("file_name"))
        if str(path).endswith((".h5", ".hdf5")):
            if path not in cache:
                cache[path] = h5py.File(path, "r")
            n = cache[path][row["audio_id"]].shape[0]
        else:
            n = load_wav(str(path), sample_rate).shape[0]
        rows.append({"audio_id": row["audio_id"],
                     "duration": n / sample_rate})
    for hf in cache.values():
        hf.close()
    pd.DataFrame(rows).to_csv(output, sep="\t", index=False)
    print(f"wrote {len(rows)} durations to {output}")


def write_audio(waveform_csv: str, out_dir: str, audio_ids=None,
                sample_rate: int = 32000) -> None:
    """Export packed waveforms back to WAV files (reference
    utils/data/write_audio.py)."""
    import h5py
    import pandas as pd
    from scipy.io import wavfile
    df = pd.read_csv(waveform_csv, sep="\t")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cache: dict = {}
    wanted = set(audio_ids) if audio_ids else None
    n = 0
    for _, row in df.iterrows():
        if wanted is not None and row["audio_id"] not in wanted:
            continue
        if row["hdf5_path"] not in cache:
            cache[row["hdf5_path"]] = h5py.File(row["hdf5_path"], "r")
        wav = cache[row["hdf5_path"]][row["audio_id"]][()]
        data = (np.asarray(wav, np.float32).clip(-1, 1)
                * 32767).astype(np.int16)
        name = str(row["audio_id"])
        if not name.endswith(".wav"):
            name += ".wav"
        wavfile.write(out / name, sample_rate, data)
        n += 1
    for hf in cache.values():
        hf.close()
    print(f"wrote {n} wav files to {out_dir}")


def link_audio(wav_csv: str, out_dir: str) -> None:
    """Symlink audio files into one directory by audio_id (reference
    utils/data/link_audio.py)."""
    import pandas as pd
    import os
    df = pd.read_csv(wav_csv, sep="\t")
    fname_col = "file_name" if "file_name" in df else "file_path"
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for _, row in df.iterrows():
        dst = out / str(row["audio_id"])
        if not dst.exists():
            os.symlink(row[fname_col], dst)
    print(f"linked {len(df)} files into {out_dir}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack")
    p.add_argument("wav_csv")
    p.add_argument("output")
    p.add_argument("--sample_rate", type=int, default=32000)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--num_shards", type=int, default=1)
    p = sub.add_parser("wav_csv")
    p.add_argument("wav_dir")
    p.add_argument("output")
    p = sub.add_parser("duration")
    p.add_argument("waveform_csv")
    p.add_argument("output")
    p.add_argument("--sample_rate", type=int, default=32000)
    p = sub.add_parser("write_audio")
    p.add_argument("waveform_csv")
    p.add_argument("out_dir")
    p.add_argument("--sample_rate", type=int, default=32000)
    p = sub.add_parser("link_audio")
    p.add_argument("wav_csv")
    p.add_argument("out_dir")
    args = ap.parse_args()
    if args.cmd == "pack":
        pack_waveform(args.wav_csv, args.output, args.sample_rate,
                      args.num_workers, args.num_shards)
    elif args.cmd == "wav_csv":
        prepare_wav_csv(args.wav_dir, args.output)
    elif args.cmd == "duration":
        prepare_duration(args.waveform_csv, args.output, args.sample_rate)
    elif args.cmd == "write_audio":
        write_audio(args.waveform_csv, args.out_dir,
                    sample_rate=args.sample_rate)
    elif args.cmd == "link_audio":
        link_audio(args.wav_csv, args.out_dir)


if __name__ == "__main__":
    main()
