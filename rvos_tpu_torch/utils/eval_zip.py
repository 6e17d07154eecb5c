"""Zip the Annotations tree for benchmark-server upload (the port's own
copy of ``rvos_tpu/utils/eval_zip.py``)."""

import os
import zipfile


def zip_folder(source_folder: str, zip_dir: str) -> None:
    with zipfile.ZipFile(zip_dir, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(source_folder):
            for f in files:
                path = os.path.join(root, f)
                zf.write(path, os.path.relpath(path, source_folder))
