"""Host C++ of the port: the pair histograms of the new-metals
distortion matrices (pair_hist.cpp, built with g++ at first use)."""
