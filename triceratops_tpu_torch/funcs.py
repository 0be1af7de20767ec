"""Host-side helpers shared with the frontend."""


def renorm_flux(flux, flux_err, star_fluxratio: float):
    """Renormalize a light curve for nearby-star flux contamination
    (reference funcs.py:164-177)."""
    renormed_flux = (flux - (1 - star_fluxratio)) / star_fluxratio
    renormed_flux_err = flux_err / star_fluxratio
    return renormed_flux, renormed_flux_err
