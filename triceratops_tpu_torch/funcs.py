"""Host-side helpers (numpy) shared with the frontend and the scenario
API: flux renormalization, contrast-curve I/O, the TRILEGAL query, save
and parse, and the SPOC aperture fetch.

Counterpart of the JAX package's ``funcs.py`` (reference
triceratops/funcs.py). The network functions import their optional
packages (mechanicalsoup, bs4, astropy) when called; ``query_TRILEGAL``
and ``save_trilegal`` print a notice and return a null result when the
service or the package is unavailable.
"""

import numpy as np
from pandas import read_csv

from .utils import profiling


def color_Teff_relations(V, Ks):
    """V - Ks -> Teff (reference funcs.py:143-161; not on the main path)."""
    if V - Ks < 5.05:
        theta = 0.54042 + 0.23676 * (V - Ks) - 0.00796 * (V - Ks) ** 2
        return 5040 / theta
    theta = (-0.4809 + 0.8009 * (V - Ks) - 0.1039 * (V - Ks) ** 2
             + 0.0056 * (V - Ks) ** 3)
    return 5040 / theta + 205.26


def renorm_flux(flux, flux_err, star_fluxratio: float):
    """Renormalize a light curve for nearby-star flux contamination
    (reference funcs.py:164-177)."""
    renormed_flux = (flux - (1 - star_fluxratio)) / star_fluxratio
    renormed_flux_err = flux_err / star_fluxratio
    return renormed_flux, renormed_flux_err


def Gauss2D(x, y, mu_x, mu_y, sigma, A):
    """Circular Gaussian PSF (reference funcs.py:180-200): a float for
    scalar x and y, else its values on the meshgrid of x and y."""
    if np.ndim(x) == 0 and np.ndim(y) == 0:
        expo = (((float(x) - mu_x) ** 2 + (float(y) - mu_y) ** 2)
                / (2 * sigma**2))
        return float(A / (2 * np.pi * sigma**2) * np.exp(-expo))
    xg, yg = np.meshgrid(x, y)
    expo = ((xg - mu_x) ** 2 + (yg - mu_y) ** 2) / (2 * sigma**2)
    return A / (2 * np.pi * sigma**2) * np.exp(-expo)


def file_to_contrast_curve(contrast_curve_file: str):
    """(separations [arcsec], |Delta_mag|) from a 2-column csv
    (reference funcs.py:203-219)."""
    data = np.loadtxt(contrast_curve_file, delimiter=",")
    return data.T[0], np.abs(data.T[1])


def separation_at_contrast(delta_mags, separations, contrasts):
    """Limiting separation at contrast via np.interp (reference
    funcs.py:222-238)."""
    return np.interp(delta_mags, contrasts, separations)


def query_TRILEGAL(RA: float, Dec: float, verbose: int = 1,
                   verify_ssl: bool = True):
    """Submit the TRILEGAL v1.6 web form, falling back to v1.5; returns the
    result URL or None (reference funcs.py:241-304). Needs mechanicalsoup;
    without it, prints a notice and returns None."""
    try:
        from mechanicalsoup import StatefulBrowser
    except ImportError:
        print("mechanicalsoup not available; TRILEGAL query skipped "
              "(B*/D* scenarios will be ignored unless a trilegal_fname "
              "is provided).")
        return None
    import ssl
    from time import sleep

    def _submit(url, photsys):
        browser = StatefulBrowser()
        if verify_ssl is False:
            ssl._create_default_https_context = ssl._create_unverified_context
            browser.session.verify = False
        browser.open(url)
        browser.select_form(nr=0)
        browser["gal_coord"] = "2"
        browser["eq_alpha"] = str(RA)
        browser["eq_delta"] = str(Dec)
        browser["field"] = "0.1"
        browser["photsys_file"] = photsys
        browser["icm_lim"] = "1"
        browser["mag_lim"] = "21"
        browser["binary_kind"] = "0"
        browser.submit_selected()
        if verbose == 1:
            print("TRILEGAL form submitted.")
        sleep(5)
        links = browser.get_current_page().select("a")
        if len(links) == 0:
            return None
        return "http://stev.oapd.inaf.it/" + links[0].get("href")[3:]

    out = _submit("http://stev.oapd.inaf.it/cgi-bin/trilegal_1.6",
                  "tab_mag_odfnew/tab_mag_TESS_2mass.dat")
    if out is not None:
        return out
    out = _submit("http://stev.oapd.inaf.it/cgi-bin/trilegal_1.5",
                  "tab_mag_odfnew/tab_mag_2mass.dat")
    if out is None:
        print("TRILEGAL too busy, using saved stellar populations instead.")
    return out


def save_trilegal(output_url, ID):
    """Poll the TRILEGAL result URL until the run has ended and save it as
    ``<ID>_TRILEGAL.csv`` in the working directory; returns the file name,
    or 0.0 when there is no result URL (reference funcs.py:307-333)."""
    from time import sleep

    if output_url is None:
        print("Could not access TRILEGAL. Ignoring BTP, BEB, BEBx2P, DTP, "
              "DEB, and DEBx2P scenarios.")
        return 0.0
    for _ in range(1000):
        last = read_csv(output_url, header=None)[-1:]
        if last.values[0, 0] == "#TRILEGAL normally terminated":
            break
        print("...")
        sleep(10)
    df = read_csv(output_url, sep=r"\s+")
    fname = str(ID) + "_TRILEGAL.csv"
    df.to_csv(fname)
    return fname


@profiling.span("tri.io.trilegal")
def trilegal_results(trilegal_fname: str, Tmag: float):
    """Parse a saved TRILEGAL csv (reference funcs.py:335-403): drop its
    last two lines (the service's termination banner), compute Tmag from
    J - Ks (Stassun et al. 2018) when the TESS column is absent, and keep
    the stars no brighter than the target (Tmags >= Tmag). Counts
    ``io.trilegal_read``."""
    profiling.count("io.trilegal_read")
    df = read_csv(trilegal_fname)[:-2]
    Masses = df["Mact"].values.astype(float)
    loggs = df["logg"].values.astype(float)
    Teffs = 10 ** df["logTe"].values.astype(float)
    Zs = np.array(df["[M/H]"], dtype=float)
    Jmags = df["J"].values.astype(float)
    Hmags = df["H"].values.astype(float)
    Kmags = df["Ks"].values.astype(float)
    if "TESS" in df.columns:
        Tmags = df["TESS"].values.astype(float)
    else:
        jk = Jmags - Kmags
        Tmags = np.where(
            (jk >= -0.1) & (jk <= 0.7),
            Jmags + 1.22163 * jk**3 - 1.74299 * jk**2 + 1.89115 * jk + 0.0563,
            np.where((jk > 0.7) & (jk <= 1.0),
                     Jmags - 269.372 * jk**3 + 668.453 * jk**2
                     - 545.64 * jk + 147.811,
                     np.where(jk < -0.1, Jmags + 0.5, Jmags + 1.75)))
    mask = Tmags >= Tmag
    return (Tmags[mask], Masses[mask], loggs[mask], Teffs[mask], Zs[mask],
            Jmags[mask], Hmags[mask], Kmags[mask])


def segment_ID(str_segment):
    """Zero-pad a TIC-ID segment to 4 characters (reference
    funcs.py:405-419)."""
    return str_segment.zfill(4)


def find_url(ID: str, sector: int):
    """The sector's SPOC s_lc.fits URL, from the archive's directory
    listing for the zero-padded TIC ID (reference funcs.py:422-453). Needs
    bs4."""
    from urllib.request import urlopen
    from bs4 import BeautifulSoup

    url = "https://archive.stsci.edu/missions/tess/tid/"
    padded = str(ID).zfill(16)
    url += "/".join(["s" + str(sector).zfill(4), padded[0:4], padded[4:8],
                     padded[8:12], padded[12:16]]) + "/"
    soup = BeautifulSoup(urlopen(url).read().decode("utf-8"), "html.parser")
    for link in soup.find_all("a"):
        if link.get("href")[-9:] == "s_lc.fits":
            url += link.get("href")
    return url


def get_aperture(ID, sector):
    """SPOC aperture pixels (column, row) of a sector: the maximal pixels
    of the light-curve file's aperture bitmap (HDU 2), offset by its
    CRVAL1P / CRVAL2P (reference funcs.py:455-475). Needs astropy."""
    from astropy.io import fits

    with fits.open(find_url(ID, sector), mode="readonly") as hdulist:
        aperture = hdulist[2].data
        ap_pixels = np.argwhere(aperture == np.max(aperture))
        ap_pixels[:, 0] += hdulist[2].header["CRVAL2P"]
        ap_pixels[:, 1] += hdulist[2].header["CRVAL1P"]
    return np.flip(ap_pixels, axis=1)
