from .lum import LumFileContent, parse_lum, read_lum_file, write_lum_file
from .png import read_png, write_png
from .wavefront import WavefrontArguments, WavefrontResult, read_obj_file
