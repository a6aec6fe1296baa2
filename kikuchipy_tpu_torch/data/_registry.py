"""Dataset registry: MD5 hashes and canonical download URLs for the
example datasets (a copy of ``kikuchipy_tpu/data/_registry.py``; the
hashes and URLs identify the same public files as kikuchipy's
``data/_registry.py``).

It takes the place of kikuchipy's pooch dependency with a small fetcher:
files are looked up under ``KP_TPU_DATA_DIR`` (or kikuchipy's in-package
data directory), optionally MD5-verified, and, only when the caller opts in
and the machine has network access, downloaded with urllib.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

# fmt: off
REGISTRY_HASHES = {
    # In package.
    "kikuchipy_h5ebsd/patterns.h5":                                 "f5e24fc55befedd08ee1b5a507e413ad",
    "emsoft_ebsd_master_pattern/ni_mc_mp_20kv_uint8_gzip_opts9.h5": "807c8306a0d02b46effbcb12bd44cd02",
    "nickel_ebsd_large/patterns.h5":                                "51d6bc0f5ff23dcb0c1a8e1f4c52d4d4",
    # GitHub (pyxem/kikuchipy-data).
    "silicon_ebsd_moving_screen/si_in.h5":                          "d8561736f6174e6520a45c3be19eb23a",
    "silicon_ebsd_moving_screen/si_out5mm.h5":                      "77dd01cc2cae6c1c5af6708260c94cab",
    "silicon_ebsd_moving_screen/si_out10mm.h5":                     "0b4ece1533f380a42b9b81cfd0dd202c",
    # Zenodo.
    "si_wafer/Pattern.dat":                                         "58952a93c3ecacff22955f1ad7c61246",
    "ni_gain/1/Pattern.dat":                                        "79febebf41b0d0a12781501a7564a721",
    "ni_gain/1/Setting.txt":                                        "776b1a2da5c359b0d399b50be5b5144b",
    "ni_gain/2/Pattern.dat":                                        "4659a9e492b14b02d1f5492c5b8cf05a",
    "ni_gain/2/Setting.txt":                                        "3f227e27ee71dc4bcf164c5d3043f03a",
    "ni_gain/3/Pattern.dat":                                        "b923be74ef642d8fe961c2356c160236",
    "ni_gain/3/Setting.txt":                                        "c1c19b77ced0cc644827b1edac615e21",
    "ni_gain/4/Pattern.dat":                                        "b91a8f63ac5f5cdcc508074aa6ffe598",
    "ni_gain/4/Setting.txt":                                        "3f68f0b1f4ca16f1a8f8e6b36613e0c2",
    "ni_gain/5/Pattern.dat":                                        "94773dc46aa3ca5142dd1b70715bbb77",
    "ni_gain/5/Setting.txt":                                        "e6e2c83c5903a3fdac92bd8b5afc9aa7",
    "ni_gain/6/Pattern.dat":                                        "fd444d5bc7d283230fd1a76f220c42db",
    "ni_gain/6/Setting.txt":                                        "21a0e8530930ba8df35dbb68c330241f",
    "ni_gain/7/Pattern.dat":                                        "7d04e558adc3ed4249768cb9515b0c04",
    "ni_gain/7/Setting.txt":                                        "1fb6b657c07daa719865e8acc57b335c",
    "ni_gain/8/Pattern.dat":                                        "c2106626d0a06118c647c21e1acc3f11",
    "ni_gain/8/Setting.txt":                                        "86a108169e410018db460e3ce1e8978e",
    "ni_gain/9/Pattern.dat":                                        "106c8e6eb1083c08f8ca2bc2f735cb31",
    "ni_gain/9/Setting.txt":                                        "7d6d422b0ee00b4b497c1503ae88dc42",
    "ni_gain/10/Pattern.dat":                                       "bd9be321d3a4cd8f3954bb8774fc70ba",
    "ni_gain/10/Setting.txt":                                       "515b3d8e4657dbc0b7566977b4a3eaca",
    "ebsd_master_pattern/al_mc_mp_20kv.h5":                         "be0f79dd025d9c82e413ce8d635d48f4",
    "ebsd_master_pattern/ni_mc_mp_20kv.h5":                         "8b69c071a036ad3488d465093b67fe4d",
    "ebsd_master_pattern/si_mc_mp_20kv.h5":                         "d4962b97bf364c42e3bd5ce1b2711d02",
    "ebsd_master_pattern/austenite_mc_mp_20kv.h5":                  "ca5c9961ce8c9ebf33802d0769876256",
    "ebsd_master_pattern/ferrite_mc_mp_20kv.h5":                    "4b6c1456ed2d90e190c7a21c4c4c1aff",
    "ebsd_master_pattern/steel_sigma_mc_mp_20kv.h5":                "2d965e399dbc13cb5983f29ceef6dfcd",
    "ebsd_master_pattern/steel_chi_mc_mp_20kv.h5":                  "9e4dd974bf78a3f7d159575ff0d0a28a",
    "ebsd_master_pattern/steel_sigma2_mc_mp_20kv.h5":               "66c36d4bc0b7029038f59d1ab423c970",
    "ebsd_master_pattern/r_mc_mp_20kv.h5":                          "1a9dc668e4d27d13ab1d3cbdca5bcd84",
    "ebsd_master_pattern/pi_mc_mp_20kv.h5":                         "8e642ad0464e1396beed0f6f41d97f85",
    "ebsd_master_pattern/cr2n_mc_mp_20kv.h5":                       "b0b03f41cc1ae3fa0b2f2bf69d494417",
    "ebsd_master_pattern/al6mn_mc_mp_20kv.h5":                      "a00f332a77d60be48584df779da5aa1f",
    "ebsd_master_pattern/alpha_almnsi_mc_mp_20kv.h5":               "92d18a632b539d7a4548ba99aa94d7f1",
}

_KP_DATA_REPO = (
    "https://raw.githubusercontent.com/pyxem/kikuchipy-data/"
    "bcab8f7a4ffdb86a97f14e2327a4813d3156a85e/"
)
REGISTRY_URLS = {
    "nickel_ebsd_large/patterns.h5":            _KP_DATA_REPO + "nickel_ebsd_large/patterns_v2.h5",
    "silicon_ebsd_moving_screen/si_in.h5":      _KP_DATA_REPO + "silicon_ebsd_moving_screen/si_in.h5",
    "silicon_ebsd_moving_screen/si_out5mm.h5":  _KP_DATA_REPO + "silicon_ebsd_moving_screen/si_out5mm.h5",
    "silicon_ebsd_moving_screen/si_out10mm.h5": _KP_DATA_REPO + "silicon_ebsd_moving_screen/si_out10mm.h5",
    "ebsd_master_pattern/al_mc_mp_20kv.h5":           "https://zenodo.org/record/7628365/files/al_mc_mp_20kv.h5",
    "ebsd_master_pattern/ni_mc_mp_20kv.h5":           "https://zenodo.org/record/7498645/files/ni_mc_mp_20kv.h5",
    "ebsd_master_pattern/si_mc_mp_20kv.h5":           "https://zenodo.org/record/7498729/files/si_mc_mp_20kv.h5",
    "ebsd_master_pattern/austenite_mc_mp_20kv.h5":    "https://zenodo.org/record/7628387/files/austenite_mc_mp_20kv.h5",
    "ebsd_master_pattern/ferrite_mc_mp_20kv.h5":      "https://zenodo.org/record/7628394/files/ferrite_mc_mp_20kv.h5",
    "ebsd_master_pattern/steel_chi_mc_mp_20kv.h5":    "https://zenodo.org/record/7628417/files/steel_chi_mc_mp_20kv.h5",
    "ebsd_master_pattern/steel_sigma_mc_mp_20kv.h5":  "https://zenodo.org/record/7628443/files/steel_sigma_mc_mp_20kv.h5",
    "ebsd_master_pattern/steel_sigma2_mc_mp_20kv.h5": "https://zenodo.org/records/20376903/files/steel_sigma2_mc_mp_20kv.h5",
    "ebsd_master_pattern/r_mc_mp_20kv.h5":            "https://zenodo.org/records/20376828/files/r_mc_mp_20kv.h5",
    "ebsd_master_pattern/pi_mc_mp_20kv.h5":           "https://zenodo.org/records/20376759/files/pi_mc_mp_20kv.h5",
    "ebsd_master_pattern/cr2n_mc_mp_20kv.h5":         "https://zenodo.org/records/20376534/files/cr2n_mc_mp_20kv.h5",
    "ebsd_master_pattern/al6mn_mc_mp_20kv.h5":        "https://zenodo.org/records/20376068/files/al6mn_mc_mp_20kv.h5",
    "ebsd_master_pattern/alpha_almnsi_mc_mp_20kv.h5": "https://zenodo.org/records/20376379/files/alpha_almnsi_mc_mp_20kv.h5",
    # The Si-wafer and ni_gain scans ship inside Zenodo zip archives;
    # unpack them into the cache directory manually:
    # https://zenodo.org/record/7491388 (si_wafer),
    # https://zenodo.org/record/7498632 (ni_gain scans 1-10).
}
# fmt: on


def md5sum(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def verify(path: str | Path, relpath: str) -> bool:
    """Whether ``path`` matches the registered MD5 of ``relpath``
    (True when the file is not in the registry)."""
    expected = REGISTRY_HASHES.get(relpath)
    if expected is None:
        return True
    return md5sum(path) == expected


def fetch(
    relpath: str,
    cache_dir: str | Path,
    allow_download: bool = False,
    check_hash: bool = True,
    timeout: float = 120.0,
) -> Path:
    """Return a verified local path for a registered dataset file,
    downloading it into ``cache_dir`` when permitted.

    Raises ``FileNotFoundError`` when the file is absent and downloads
    are not allowed (or no URL is registered), and ``ValueError`` on a
    hash mismatch.
    """
    target = Path(cache_dir) / relpath
    if not target.exists():
        url = REGISTRY_URLS.get(relpath)
        if not allow_download or url is None:
            raise FileNotFoundError(
                f"Dataset file {relpath} not found under {cache_dir}"
                " (override the cache location with the KP_TPU_DATA_DIR"
                " environment variable)."
                + (
                    f" Pass allow_download=True to fetch it from {url}"
                    if url
                    else " No download URL is registered; place the file"
                    " there manually (see kikuchipy_tpu_torch.data._registry)."
                )
            )
        import urllib.request

        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(target.suffix + ".part")
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            with open(tmp, "wb") as out:
                while True:
                    block = resp.read(1 << 20)
                    if not block:
                        break
                    out.write(block)
        tmp.replace(target)
    if check_hash and not verify(target, relpath):
        raise ValueError(
            f"MD5 mismatch for {target}; delete the file and re-fetch "
            "(expected " + REGISTRY_HASHES[relpath] + ")"
        )
    return target
